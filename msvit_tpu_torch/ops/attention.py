"""Masked multi-head attention (counterpart of `msvit_tpu/ops/attention.py`).

Semantics as in the JAX package: bool masks mean "True = may attend",
float masks are additive, cross-context keys/values are concatenated onto
K/V by the caller, softmax statistics are float32.

``xla_attention`` is the plain path (plain tensor ops in the JAX package
too, so plain torch here).  ``"fused"`` runs the per-head fused kernels
(`ops/fused_attention.py`): K5, or K4 with ``inference=True``, and under
autograd `FusedAttentionFunction` (K5-lse forward, K6 backward from
`ops/flash_attention.py`).  ``"flash"`` (K7, the online-softmax tiled
forward) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Large-but-finite mask value: avoids NaNs from exp(-inf - (-inf)) in fully
# masked rows while being -inf for softmax purposes in f32.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_FLASH_NOT_PORTED = (
    "attention implementation 'flash' needs K7 (ops/flash_attention.py "
    "`_flash_forward`), not ported yet (ROADMAP.md queue 2; its backward, "
    "K6, is ported and serves \"fused\")"
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


def _kernel_shapes_ok(q, k, mask) -> bool:
    """The fused kernels take 4D [B, H, N, dh] operands and no mask or a
    4D one (bool or additive)."""
    return q.ndim == 4 and k.ndim == 4 and (mask is None or mask.ndim == 4)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    implementation: str = "auto",
    output_probs: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    inference: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching attention front end, the JAX package's rule.

    "auto" takes the plain path where JAX leaves its kernels: probabilities
    requested, fewer than 512 kv tokens, or tensors on the CPU (JAX off the
    TPU).  Otherwise (K/V as long as Q or longer alike) it takes "fused":
    K5 (K5-lse and K6 under autograd), or K4 with ``inference=True``
    (serving only, not differentiable).
    JAX's VMEM gate `_fused_eligible`, which sends larger score tiles to
    flash (K7), has no counterpart: the port's fused kernels have no tile
    limit.  "fused" with probabilities requested or other than 4D operands
    takes the plain path, as in JAX."""
    if implementation == "auto":
        if output_probs or q.device.type == "cpu" or k.shape[-2] < 512:
            implementation = "xla"
        elif _kernel_shapes_ok(q, k, mask):
            implementation = "fused"
        else:
            implementation = "xla"
    if implementation == "fused" and not output_probs and _kernel_shapes_ok(q, k, mask):
        from msvit_tpu_torch.ops.fused_attention import (
            fused_attention,
            fused_attention_inference,
        )

        fn = fused_attention_inference if inference else fused_attention
        return fn(q, k, v, mask=mask, scale=scale, mask_value=mask_value), None
    if implementation == "flash":
        raise NotImplementedError(_FLASH_NOT_PORTED)
    if implementation not in ("xla", "packed", "fused"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    out, probs = xla_attention(
        q, k, v, mask=mask, scale=scale, mask_value=mask_value
    )
    return out, (probs if output_probs else None)
