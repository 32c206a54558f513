"""Order statistics and comparison numbers shared by the loops."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default); an infinite sample sorts last."""
    s = sorted(xs)
    if not s:
        return math.nan
    pos = (len(s) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or s[hi] == s[lo]:
        return float(s[lo])
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row ||got - want|| / ||want|| over all but the first axis."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)
