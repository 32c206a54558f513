"""erf-grade GELU (counterpart of `msvit_tpu/ops/gelu.py`).

Plain elementwise torch, f32 math, output in the input's dtype.  The same
functions and coefficients as the JAX package (XLA elementwise code there,
not Pallas):

* `erf` / `gelu_erf` — Abramowitz–Stegun 7.1.26 (erf abs err <= 1.5e-7);
* `erf_tanh` / `gelu_erf_tanh` — the fitted tanh-form erf (abs err
  <= 4.3e-5), the serving GELU.
"""

from __future__ import annotations

import torch

_P = 0.3275911
_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429
_INV_SQRT2 = 0.7071067811865476

_T_A = 1.12822551
_T_B = 0.10392653
_T_C = -0.00173499


def _erf_pos(x32: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 for x >= 0 (f32 in/out)."""
    t = 1.0 / (1.0 + _P * x32)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    return 1.0 - poly * torch.exp(-(x32 * x32))


def erf(x: torch.Tensor) -> torch.Tensor:
    """erf via A&S 7.1.26 (abs err <= 1.5e-7), computed in f32."""
    x32 = x.float()
    return (torch.sign(x32) * _erf_pos(x32.abs())).to(x.dtype)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU: x * Phi(x), Phi(x) = (1 + erf(x / sqrt 2)) / 2."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + erf(x32 * _INV_SQRT2))).to(x.dtype)


def erf_tanh(x: torch.Tensor) -> torch.Tensor:
    """erf via the fitted tanh form (abs err <= 4.3e-5), f32 math; u is
    clamped to +-6 where the fit would turn (erf(6) = 1 - 2e-17)."""
    u = x.float().clamp(-6.0, 6.0)
    u2 = u * u
    return torch.tanh(u * (_T_A + u2 * (_T_B + u2 * _T_C))).to(x.dtype)


def gelu_erf_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh-form erf: erf-grade accuracy at tanh cost."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + erf_tanh(x32 * _INV_SQRT2))).to(x.dtype)
