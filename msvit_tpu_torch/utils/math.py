"""Math helpers (the port's copies from `msvit_tpu/utils/math.py`)."""

from __future__ import annotations

import numpy as np
import torch


def multiclass_logits(t: torch.Tensor) -> torch.Tensor:
    """Centered log over the last axis: log t minus its mean."""
    logits = torch.log(t)
    return logits - logits.mean(-1, keepdim=True)


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in f32 step for step: start (1 - t)
    + stop t with t = i / (num - 1) for i < num - 1, then stop itself (the
    bounds rounded to f32 first; no host-to-device copy)."""
    lo, hi = float(np.float32(start)), float(np.float32(stop))
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([lo * (1.0 - t) + hi * t,
                      torch.full((1,), hi, dtype=torch.float32, device=device)])
