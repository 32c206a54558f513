"""Flash attention (counterpart of `msvit_tpu/ops/flash_attention.py`).

* `flash_attention_bwd` -- K6, the TPU kernel `flash_attention_bwd` (its
  dQ and dK/dV pallas_calls): dq, dk, dv from the forward's residuals (q,
  k, v, mask, out and the compact lse ``[B, H, Nq]``) and the cotangent of
  out.  Kernel: `csrc/flash_attention_bwd.cu`.  As in the JAX package it
  is the backward of the fused attention's custom VJP
  (`ops/fused_attention.py::FusedAttentionFunction`).
* `flash_attention` -- K7, the online-softmax tiled forward: not ported
  yet, raises.

The wrapper takes the plain version for a tensor on the CPU, and for a
tensor on the card launches the kernel or raises: there is no fallback.
It counts its launches (`.launches`, one per call of both kernels).

Rounding, as the TPU kernels: p = exp(s - lse) stays f32 into
ds = p (dp - delta); p is rounded to the compute dtype only as the operand
of dV = p^T g, and ds only as the operand of dq and dk.  (K2, the packed
backward, rounds p first; its plain version is not this one's.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from msvit_tpu_torch.ops import _build
from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu_torch.ops.fused_attention import (
    _dims, _kernel_operands, _mask_args, _strides)
from msvit_tpu_torch.ops.packed_attention import _DTYPE_CODES, _acc, _ptr, _scores


def flash_attention(*args, **kwargs):
    """K7, `_flash_forward`: not ported yet."""
    raise NotImplementedError(
        "flash_attention needs K7 (ops/flash_attention.py `_flash_forward`, "
        "the online-softmax tiled forward), not ported yet (ROADMAP.md queue 2)")


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6, the TPU kernels' `_recompute_p_ds` and their
    two sums step for step: g cast to q's dtype; s = q.k^T * scale in f32
    with the mask; p = exp(s - lse), not rounded; dp = g.v^T and
    delta = sum(g * o) in f32; ds = p (dp - delta) in f32;
    dv = p.to(dtype)^T g; dk = ds.to(dtype)^T q * scale;
    dq = ds.to(dtype) k * scale.  f64 inputs compute in f64."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    dt, acc = q.dtype, _acc(q.dtype)
    gf = g.to(dt).to(acc)
    s = _scores(q, k, scale, mask, mask_value, acc)
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.matmul(gf, v.to(acc).transpose(-1, -2))
    delta = (gf * out.to(acc)).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).to(acc)
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), gf)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    dq = torch.matmul(ds, k.to(acc)) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the exact softmax attention (K6).  q [B, H, Nq, dh]; k, v
    [B, H, Nk, dh]; out [B, H, Nq, dh] and lse [B, H, Nq] the forward's
    (`fused_attention_lse`); g [B, H, Nq, dh] the cotangent of out, any
    strides; mask and scale as in the forward.  Returns (dq, dk, dv) in the
    operands' dtype.  Nothing flows to the mask."""
    name = "flash_attention_bwd"
    b, h, nq, nk, dh = _dims(q, k, v)
    if scale is None:
        scale = 1.0 / dh**0.5
    if tuple(out.shape) != (b, h, nq, dh) or tuple(g.shape) != (b, h, nq, dh):
        raise ValueError(f"{name}: out {tuple(out.shape)} and g {tuple(g.shape)} "
                         f"must be {(b, h, nq, dh)}")
    if tuple(lse.shape) != (b, h, nq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} must be {(b, h, nq)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, g, lse, mask, scale, mask_value)
    q, k, v, out, g = _kernel_operands(name, dh, q, k, v, out, g.to(q.dtype))
    if lse.device != q.device:
        raise ValueError(f"{name}: lse on another device")
    lse = lse.to(torch.float32).contiguous()
    kind, m, sb, sh = _mask_args(mask, b, h, nq, nk, q.device, name)

    def grad(n):  # [B, n, H, dh] in memory, the layout the QKV GEMM's views take
        return torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)

    dq, dk, dv = grad(nq), grad(nk), grad(nk)
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.msvit_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), _ptr(m), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODES[q.dtype], b, h, nq, nk, dh,
            _strides(q, k, v, out, g, dq, dk, dv), kind, sb, sh, float(scale),
            float(mask_value), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
