"""Math helpers (the port's copies from `msvit_tpu/utils/math.py`)."""

from __future__ import annotations

import torch


def multiclass_logits(t: torch.Tensor) -> torch.Tensor:
    """Centered log over the last axis: log t minus its mean."""
    logits = torch.log(t)
    return logits - logits.mean(-1, keepdim=True)
