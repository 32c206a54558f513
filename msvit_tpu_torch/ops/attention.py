"""Masked multi-head attention (counterpart of `msvit_tpu/ops/attention.py`).

Semantics as in the JAX package: bool masks mean "True = may attend",
float masks are additive, cross-context keys/values are concatenated onto
K/V by the caller, softmax statistics are float32.

``xla_attention`` is the plain path (plain tensor ops in the JAX package
too, so plain torch here).  The Pallas kernels the JAX dispatch can reach
(`fused` K4/K5, `flash` K7) are not ported yet: asking for them raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Large-but-finite mask value: avoids NaNs from exp(-inf - (-inf)) in fully
# masked rows while being -inf for softmax purposes in f32.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_NOT_PORTED = (
    "attention implementation {!r} needs a kernel not ported yet "
    "(ops/fused_attention.py K4/K5, ops/flash_attention.py K7; ROADMAP.md "
    "queue 2)"
)


def _apply_mask(
    scores: torch.Tensor, mask: Optional[torch.Tensor], mask_value: float
) -> torch.Tensor:
    if mask is None:
        return scores
    if mask.dtype == torch.bool:
        return scores.masked_fill(~mask, mask_value)
    return scores + mask.to(scores.dtype)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-semantics attention.

    q: [..., H, Nq, Dh]; k, v: [..., H, Nk, Dh]; mask broadcastable to
    [..., H, Nq, Nk].  Returns (out [..., H, Nq, Dh] in q's dtype,
    probs [..., H, Nq, Nk] f32).  Products are taken in f32 on upcast
    inputs, the counterpart of `preferred_element_type=float32`."""
    dh = q.shape[-1]
    scale = (1.0 / dh**0.5) if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = _apply_mask(scores, mask, mask_value)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype), probs


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    implementation: str = "auto",
    output_probs: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching attention front end.

    "auto" takes the plain path where the JAX package leaves its kernels:
    probabilities requested, K/V longer than Q, fewer than 512 kv tokens,
    or tensors on the CPU.  Elsewhere on the card JAX would run the
    fused/flash kernels, which this port does not have yet, so it raises
    rather than silently running a different path."""
    if implementation == "auto":
        plain = (
            output_probs
            or q.device.type == "cpu"
            or k.shape[-2] != q.shape[-2]
            or k.shape[-2] < 512
        )
        if not plain:
            raise NotImplementedError(_NOT_PORTED.format("auto (fused/flash)"))
        implementation = "xla"
    if implementation in ("fused", "flash"):
        raise NotImplementedError(_NOT_PORTED.format(implementation))
    if implementation not in ("xla", "packed"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    out, probs = xla_attention(
        q, k, v, mask=mask, scale=scale, mask_value=mask_value
    )
    return out, (probs if output_probs else None)
