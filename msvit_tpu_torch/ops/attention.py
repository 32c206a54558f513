"""Masked multi-head attention (counterpart of `msvit_tpu/ops/attention.py`).

Semantics as in the JAX package: bool masks mean "True = may attend",
float masks are additive, cross-context keys/values are concatenated onto
K/V by the caller, softmax statistics are float32.

``xla_attention`` is the plain path (plain tensor ops in the JAX package
too, so plain torch here).  ``"fused"`` runs the per-head fused kernels
(`ops/fused_attention.py`): K5, or K4 with ``inference=True``, and under
autograd `FusedAttentionFunction` (K5-lse forward, K6 backward from
`ops/flash_attention.py`).  ``"flash"`` runs K7, the online-softmax tiled
forward (`ops/flash_attention.py`), with or without ``inference`` (JAX's
flash route has no shaved variant), and under autograd
`FlashAttentionFunction` (K7-lse forward, K6 backward).

"auto" chooses between "fused" and "flash" by JAX's `_fused_eligible`, a
plain shape rule here: the padded f32 score tile of one head plus its
mask tile within 12 MiB takes "fused", a larger one "flash".  The port's
kernels have no such limit; the rule is kept so that one config reaches
the same kernel in both packages (the 816-token multistate trunk K4/K5,
its 3168-token 448-px trunk K7).  The packed path's VMEM gates
(`packed_vmem_ok`, `grouped_vmem_ok`) stay unported: the port's unmasked
ViT-B/8 at 448 px keeps K1 (`models/base/model.py`) where JAX falls to
flash.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Large-but-finite mask value: avoids NaNs from exp(-inf - (-inf)) in fully
# masked rows while being -inf for softmax purposes in f32.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# JAX's budget for one head's f32 scores plus its mask in the single-pass
# fused kernel (`msvit_tpu/ops/attention.py::_fused_eligible`)
FUSED_TILE_BYTES = 12 * 1024 * 1024


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


def _fused_eligible(q, k, mask) -> bool:
    """JAX's `_fused_eligible`: the padded (to 128) f32 scores of one head,
    plus its mask tile (a quarter of that for bool, as much for additive),
    within `FUSED_TILE_BYTES`."""
    def pad(n):
        return -(-n // 128) * 128

    scores = pad(q.shape[-2]) * pad(k.shape[-2]) * 4
    m_bytes = 0
    if mask is not None:
        m_bytes = scores // 4 if mask.dtype == torch.bool else scores
    return scores + m_bytes <= FUSED_TILE_BYTES


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
    TPU).  Otherwise (K/V as long as Q or longer alike) it takes "fused"
    where `_fused_eligible` admits the shape: K5 (K5-lse and K6 under
    autograd), or K4 with ``inference=True`` (serving only, not
    differentiable); and "flash" beyond it: K7 (K7-lse and K6 under
    autograd), ``inference`` or not.  "fused" or "flash" with
    probabilities requested or other than 4D operands take the plain path,
    as in JAX."""
    if implementation == "auto":
        if output_probs or q.device.type == "cpu" or k.shape[-2] < 512:
            implementation = "xla"
        elif not _kernel_shapes_ok(q, k, mask):
            implementation = "xla"
        else:
            implementation = "fused" if _fused_eligible(q, k, mask) else "flash"
    kernel_ok = not output_probs and _kernel_shapes_ok(q, k, mask)
    if implementation == "fused" and kernel_ok:
        from msvit_tpu_torch.ops.fused_attention import (
            fused_attention,
            fused_attention_inference,
        )

        fn = fused_attention_inference if inference else fused_attention
        return fn(q, k, v, mask=mask, scale=scale, mask_value=mask_value), None
    if implementation == "flash" and kernel_ok:
        from msvit_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, mask=mask, scale=scale, mask_value=mask_value), None
    if implementation not in ("xla", "packed", "fused", "flash"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    out, probs = xla_attention(
        q, k, v, mask=mask, scale=scale, mask_value=mask_value
    )
    return out, (probs if output_probs else None)
