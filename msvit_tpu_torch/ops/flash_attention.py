"""Flash attention (counterpart of `msvit_tpu/ops/flash_attention.py`).

* `flash_attention` -- K7, the TPU kernel `_flash_forward` (body
  `_fwd_kernel`): the exact online-softmax attention that "auto" takes
  where one head's score tile outgrows the single-pass fused kernel's
  budget (`ops/attention.py::_fused_eligible`; the multistate trunk at
  448 px, 3168 tokens).  Kernel: `csrc/flash_attention.cu`; bf16 on the
  tensor cores, at head size 64 on `wgmma` fed by TMA
  (`csrc/attention_wgmma.cuh`), at other head sizes on `mma.sync`
  (`csrc/attention_mma.cuh`), f32 on the CUDA cores.  K7 and K7-lse count
  their launches by route (`ops/packed_attention.py::kernel_route`,
  `route_counts`); on the wgmma route q, k and v are read through 4-D TMA
  maps as they are, and a view TMA cannot map (`tma_map_heads`) raises a
  `ValueError` naming the wrapper.
* `flash_attention_lse` -- K7-lse, the same kernel's `with_lse` branch:
  K7 plus a compact lse ``[B, H, Nq]`` f32 (0 where l == 0).  The TPU's
  lane-replicated ``[B, H, Nq_pad, 128]`` layout, of which its VJP keeps
  lane 0, does not carry over.
* `flash_attention_bwd` -- K6, the TPU kernel `flash_attention_bwd` (its
  dQ and dK/dV pallas_calls): dq, dk, dv from the forward's residuals (q,
  k, v, mask, out and the compact lse) and the cotangent of out.  Kernel:
  `csrc/flash_attention_bwd.cu`: bf16 on the tensor cores, at head size 64
  on `wgmma` fed by TMA (`csrc/attention_bwd_wgmma.cuh`), at other head
  sizes on `mma.sync`; f32 on the CUDA cores; two kernels, no atomics.  It
  counts its launches by route, as K7 does.  On the wgmma route q, k, v
  and the cotangent are read through 4-D TMA maps: a q, k or v view TMA
  cannot map raises, the cotangent is copied where TMA cannot take it as
  autograd hands it over (`tma_heads_operand`: an expanded gradient of
  ``(out * w).sum()``).  As in the JAX package it is the backward of both
  custom VJPs: `FlashAttentionFunction` here and
  `ops/fused_attention.py::FusedAttentionFunction`.

`flash_attention` splits as the JAX `custom_vjp` `_flash` does: under
autograd (grad enabled and q, k or v requiring grad) it runs
`FlashAttentionFunction`, K7-lse forward and K6 backward; otherwise K7.
Operands, masks and strides as `ops/fused_attention.py` (Nq != Nk, bool or
additive masks ``[B|1, 1|H, 1|Nq, Nk]``, q/k/v read through their strides).

The wrappers take the plain version for a tensor on the CPU, and for a
tensor on the card launch the kernel or raise: there is no fallback.  Each
counts its launches (`.launches`; K6 one per call of both its kernels), by
route too (`ops/packed_attention.py::route_counts`).
K7 (the no-grad branch of `flash_attention`) is the registered op
`torch.ops.msvit.flash_attention`, as K4 and K5 are
(`ops/fused_attention.py`), so that an exported 448-px or subsample
forward keeps it as one node.

K7's plain version is K5's: the two TPU kernels compute one function (the
exact max-subtracted softmax, p rounded to the compute dtype into P.V, l
summed from the unrounded p) and differ in their tiling only.  The kernel
runs bf16 on the tensor cores and rounds p to bf16 into P.V as the TPU
kernel does (against the running max, where the plain version takes the
row's max: a p can round one bf16 step apart); f32 runs on the CUDA cores,
where the rounding is the identity.  Fully masked
rows: the port gives mean(V) over the Nk real keys; the TPU kernel pads Nk
to ``nk_pad = ceil(Nk / bk) * bk``, ``bk = min(1024, ceil128(Nk))``, and
counts the padded keys with p = 1: sum(V) / nk_pad
(`tests/test_torch_flash.py::test_fully_masked_row_deviation`).

K6's rounding, as the TPU kernels: p = exp(s - lse) stays f32 into
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
    FusedAttentionFunction, _check_operands, _dims, _mask_args, _operand,
    _requires_grad, _run, _strides, attention_fake, call_op,
    fused_attention_lse_plain, fused_attention_plain)
from msvit_tpu_torch.ops.packed_attention import (
    _DTYPE_CODES, _acc, _count_route, _ptr, _scores, check_tma_heads, kernel_route,
    tma_heads_operand, zero_counts)


# ----------------------------------------------------------------- K7 ----


# K7's plain versions are K5's: the two TPU kernels compute one function
# (f32 scores times `scale`, the mask after the upcast, the max-subtracted
# softmax, P.V with p rounded to v's dtype, times 1/l, 1 where l == 0;
# lse = m + log l, 0 where l == 0) and differ in their tiling only.
flash_attention_lse_plain = fused_attention_lse_plain
flash_attention_plain = fused_attention_plain


def _flash_k7(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], scale: float,
              mask_value: float) -> torch.Tensor:
    """K7, the body of the registered op `torch.ops.msvit.flash_attention`:
    the plain version on the CPU, the kernel on the card (or an
    exception)."""
    return _run(flash_attention, "msvit_flash_attention", flash_attention_plain,
                q, k, v, mask, scale, mask_value)


_flash_attention_op = torch.library.custom_op(
    "msvit::flash_attention", _flash_k7, mutates_args=())
_flash_attention_op.register_fake(attention_fake)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Exact softmax attention, the long-sequence kernel.  q [B, H, Nq, dh];
    k, v [B, H, Nk, dh]; bf16 or f32; mask [B|1, 1|H, 1|Nq, Nk] bool or
    additive; scale defaults to 1/sqrt(dh).  Returns [B, H, Nq, dh] in q's
    dtype.

    Under autograd (grad enabled and q, k or v requiring grad) this is
    `FlashAttentionFunction`: K7-lse forward, K6 backward.  Otherwise K7
    (through the registered op `torch.ops.msvit.flash_attention` when
    traced)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if _requires_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, mask, float(scale),
                                            float(mask_value))
    return call_op(_flash_k7, torch.ops.msvit.flash_attention, "flash_attention",
                   q, k, v, mask, scale, mask_value)


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (K7-lse): K7's output and lse [B, H, Nq] f32.
    Arguments as `flash_attention`; not differentiable itself
    (`FlashAttentionFunction` is)."""
    return _run(flash_attention_lse, "msvit_flash_attention_lse",
                flash_attention_lse_plain, q, k, v, mask, scale, mask_value,
                with_lse=True)


zero_counts(flash_attention, flash_attention_lse)


class FlashAttentionFunction(FusedAttentionFunction):
    """The JAX `_flash` custom VJP: the forward is K7-lse and saves
    (q, k, v, mask, out, lse), the backward is K6 (inherited from
    `FusedAttentionFunction`, whose VJP is the same).  On the CPU both run
    their plain versions.  Nothing flows to the mask, `scale` or
    `mask_value`."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, mask_value):
        out, lse = flash_attention_lse(q, k, v, mask, scale, mask_value)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (scale, mask_value)
        return out


# ----------------------------------------------------------------- K6 ----


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
    g = g.to(q.dtype)
    _check_operands(name, dh, q, k, v, out, g)
    route = kernel_route(q.dtype, dh)
    if route == "wgmma":  # q, k, v mapped as they are; the cotangent as TMA takes it
        check_tma_heads(name, q, k, v)
        g, out = tma_heads_operand(g), _operand(out)
    else:
        q, k, v, out, g = (_operand(t) for t in (q, k, v, out, g))
    if lse.device != q.device:
        raise ValueError(f"{name}: lse on another device")
    lse = lse.to(torch.float32).contiguous()
    kind, m, sb, sh, sr = _mask_args(mask, b, h, nq, nk, q.device, name)

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
            _strides(q, k, v, out, g, dq, dk, dv), kind, sb, sh, sr, float(scale),
            float(mask_value), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    _count_route(flash_attention_bwd, route)
    return dq, dk, dv


zero_counts(flash_attention_bwd)
