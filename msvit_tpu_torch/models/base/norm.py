"""LayerNorm with float32 statistics and compute-dtype output (counterpart
of `msvit_tpu/models/base/norm.py`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Moments and normalization in f32, cast to `out_dtype` on the way out."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


class LayerNorm(nn.Module):
    def __init__(
        self,
        dim: int,
        eps: float = 1e-6,
        out_dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        bias: bool = True,
    ):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        if bias:
            self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))
        else:  # flax `LayerNorm(use_bias=False)`
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.out_dtype)
