"""Per-head fused attention (counterpart of `msvit_tpu/ops/fused_attention.py`).

Attention on ``q [B, H, Nq, dh]`` and ``k, v [B, H, Nk, dh]`` (Nq != Nk
allowed: cross-context K/V), bool (True = attend) or additive f32 masks
``[B|1, 1|H, Nq, Nk]`` applied after the f32 upcast.  Three kernels, one
hand-written CUDA source for Hopper (`csrc/fused_attention.cu`) with three
entry points, each with a plain PyTorch version beside it.  In bf16 all
three run on the tensor cores in the tile body K7 runs
(`csrc/attention_mma.cuh`: `mma.sync` tiles fed by a `cp.async` ring of k/v
and mask tiles), K5 and K5-lse with its exact online softmax and K4 with
the shaved one; f32 runs a kernel on the CUDA cores (TF32 would not keep
the f32 bars):

* `fused_attention` -- K5, the TPU kernel `_fused_forward` without its lse
  branch: the exact, max-subtracted softmax (the bf16 eval forward of the
  multistate encoder).
* `fused_attention_lse` -- K5-lse, the same TPU kernel's `with_lse` branch:
  K5 plus a compact lse ``[B, H, Nq]`` f32, the training forward.
* `fused_attention_inference` -- K4, the TPU kernel `_fused_inference`:
  the shaved serving softmax exp(clip(s, +-80)) with no row max, exact for
  |s| < 80 (the multistate int8 serving forward).

`fused_attention` splits as the JAX `custom_vjp` `_fused` does: under
autograd (grad enabled and q, k or v requiring grad) it runs
`FusedAttentionFunction`, K5-lse forward and K6 backward
(`ops/flash_attention.py::flash_attention_bwd`); otherwise K5.  K4 has no
gradient (the TPU function has no VJP): under autograd on the card it
raises.

The kernels read q, k, v through their strides (the last dim contiguous),
so views of the QKV GEMM output need no copy, and write the output
``[B, Nq, H, dh]`` in memory, returned as the ``[B, H, Nq, dh]`` view.
As the TPU kernels, they round p to the compute dtype into P.V and sum the
unrounded p into l; K5 and K5-lse round p against the running max of 64-key
tiles, their plain versions against the row's max (a p can round one bf16
step apart).  K4 has no max: an additive -inf entry clamps to -80 as a
masked one does, so a row of them is mean(V), not zeros as in K5.

Each wrapper takes the plain version for a tensor on the CPU, and for a
tensor on the card launches its kernel or raises: there is no fallback.
Each counts its kernel launches (`.launches`).

Fully masked rows: the port gives mean(V) over the Nk keys.  The TPU
kernels give sum(V) / (ceil(Nk / 128) * 128): the keys they pad up to a
multiple of 128 enter the softmax's denominator (K5 with p = exp(0), K4
with exp(-80)).  The port does not copy that padding artifact
(`tests/test_torch_multistate.py::test_fully_masked_row_deviation`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from msvit_tpu_torch.ops import _build
from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu_torch.ops.packed_attention import _DTYPE_CODES, _acc, _ptr, _scores


def _dims(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q, k, v must be [B, H, N, dh]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if tuple(k.shape) != (b, h, nk, dh) or tuple(v.shape) != (b, h, nk, dh):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"[{b}, {h}, Nk, {dh}]")
    return b, h, nq, nk, dh


# ---------------------------------------------------------- plain versions


def fused_attention_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5-lse, the TPU kernel `_kernel` with its lse, step
    for step: f32 scores times `scale`, the mask after the upcast, m = row
    max, p = exp(s - m), l = sum p in f32, P.V with p rounded to v's dtype,
    times 1/l (1 where l == 0), lse = m + log l (0 where l == 0).  A row
    whose scores are all -inf gives zeros and lse 0.  Returns (out
    [B, H, Nq, dh] in q's dtype, lse [B, H, Nq] f32); f64 inputs compute in
    f64."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    acc = _acc(q.dtype)
    s = _scores(q, k, scale, mask, mask_value, acc)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == -torch.inf, 0.0, m)  # all -inf: p = 0, not NaN
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    o = (o * torch.where(l == 0.0, 1.0, 1.0 / l)).to(q.dtype)
    return o, torch.where(l > 0.0, m + torch.log(l), 0.0).squeeze(-1)


def fused_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Plain version of K5: `fused_attention_lse_plain`'s output."""
    return fused_attention_lse_plain(q, k, v, mask, scale, mask_value)[0]


def fused_attention_inference_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Plain version of K4, the TPU kernel `_kernel_inference` step for
    step: f32 scores times `scale`, the mask after the upcast,
    p = exp(clip(s, -80, 80)), l = sum p in f32, P.V with p rounded to v's
    dtype, then / l."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    s = _scores(q, k, scale, mask, mask_value)
    p = torch.exp(s.clamp(-80.0, 80.0))
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)


# ----------------------------------------------------------------- kernels


def _operand(t: torch.Tensor) -> torch.Tensor:
    """`t` if the kernel can read it through its strides (last dim
    contiguous, every row 16-byte aligned), else a contiguous copy."""
    es = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all((s * es) % 16 == 0 for s in t.stride()[:3]))
    return t if ok else t.contiguous()


def _kernel_operands(name: str, dh: int, *ts: torch.Tensor):
    """The [B, H, N, dh] operands of a kernel, checked (on one card, f32 or
    bf16 alike, a head size the kernels take) and made readable through
    their strides."""
    first = ts[0]
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for tensors on {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != first.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtypes {[x.dtype for x in ts]} "
                            "unsupported (f32 or bf16, all alike)")
    if dh % 8 or dh > 128:
        raise ValueError(f"{name}: head size {dh} unsupported (a multiple of 8, <= 128)")
    return [_operand(t) for t in ts]


def _strides(*ts: torch.Tensor):
    """The (image, head, row) element strides of each operand, as the C
    entry points take them (host memory)."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _mask_args(mask, b, h, nq, nk, device, name):
    """(kind, mask tensor, image stride, head stride): kind 0 none, 1 bool
    (one byte per entry), 2 additive f32; strides in elements, 0 where the
    mask broadcasts."""
    if mask is None:
        return 0, None, 0, 0
    if (mask.ndim != 4 or mask.shape[0] not in (1, b) or mask.shape[1] not in (1, h)
            or tuple(mask.shape[2:]) != (nq, nk)):
        raise ValueError(
            f"{name}: mask {tuple(mask.shape)} does not fit [B|1, 1|H, {nq}, {nk}]")
    if mask.device != device:
        raise ValueError(f"{name}: mask on another device")
    if mask.dtype == torch.bool:
        kind, m = 1, mask.view(torch.uint8)
    elif mask.is_floating_point():
        kind, m = 2, mask.to(torch.float32)
    else:
        raise TypeError(f"{name}: mask dtype {mask.dtype}")
    if m.stride(3) != 1 or m.stride(2) != nk:
        m = m.contiguous()
    sb = m.stride(0) if m.shape[0] > 1 else 0
    sh = m.stride(1) if m.shape[1] > 1 else 0
    return kind, m, sb, sh


def _run(wrapper, entry: str, plain, q, k, v, mask, scale, mask_value,
         with_lse: bool = False):
    """The plain version for CPU tensors; for CUDA tensors the kernel
    `entry` (counted on `wrapper.launches`), or an exception.  Returns out,
    or (out, lse) `with_lse`."""
    name = wrapper.__name__
    b, h, nq, nk, dh = _dims(q, k, v)
    if scale is None:
        scale = 1.0 / dh**0.5
    if q.device.type == "cpu":
        return plain(q, k, v, mask, scale, mask_value)
    q, k, v = _kernel_operands(name, dh, q, k, v)
    kind, m, sb, sh = _mask_args(mask, b, h, nq, nk, q.device, name)
    out = torch.empty((b, nq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m), out.data_ptr(),
            *([lse.data_ptr()] if with_lse else []),
            _DTYPE_CODES[q.dtype], b, h, nq, nk, dh, _strides(q, k, v, out), kind,
            sb, sh, float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    wrapper.launches += 1
    return (out, lse) if with_lse else out


def _requires_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Exact softmax attention.  q [B, H, Nq, dh]; k, v [B, H, Nk, dh];
    bf16 or f32; mask [B|1, 1|H, Nq, Nk] bool or additive; scale defaults
    to 1/sqrt(dh).  Returns [B, H, Nq, dh] in q's dtype.

    Under autograd (grad enabled and q, k or v requiring grad) this is
    `FusedAttentionFunction`: K5-lse forward, K6 backward.  Otherwise K5."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if _requires_grad(q, k, v):
        return FusedAttentionFunction.apply(q, k, v, mask, float(scale),
                                            float(mask_value))
    return _run(fused_attention, "msvit_fused_attention", fused_attention_plain,
                q, k, v, mask, scale, mask_value)


fused_attention.launches = 0


def fused_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (K5-lse): K5's output and lse [B, H, Nq] f32
    (m + log l, 0 for a row whose scores are all -inf).  Arguments as
    `fused_attention`; not differentiable itself (`FusedAttentionFunction`
    is)."""
    return _run(fused_attention_lse, "msvit_fused_attention_lse",
                fused_attention_lse_plain, q, k, v, mask, scale, mask_value,
                with_lse=True)


fused_attention_lse.launches = 0


def fused_attention_inference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Serving-only attention with the shaved softmax (K4); arguments as
    `fused_attention`.  Not differentiable (the TPU function has no VJP):
    under autograd on the card it raises."""
    if q.device.type != "cpu" and _requires_grad(q, k, v):
        raise NotImplementedError("fused_attention_inference is serving-only "
                                  "(no gradient); training takes fused_attention")
    return _run(fused_attention_inference, "msvit_fused_attention_inference",
                fused_attention_inference_plain, q, k, v, mask, scale, mask_value)


fused_attention_inference.launches = 0


class FusedAttentionFunction(torch.autograd.Function):
    """The JAX `_fused` custom VJP: the forward is K5-lse and saves
    (q, k, v, mask, out, lse), the backward is K6.  On the CPU both run
    their plain versions.  Nothing flows to the mask, `scale` or
    `mask_value`."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, mask_value):
        out, lse = fused_attention_lse(q, k, v, mask, scale, mask_value)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (scale, mask_value)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # imported here, as JAX's `_fused_bwd` imports it: the module takes
        # its operand helpers from this one
        from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd

        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, g, lse, mask, *ctx.args)
        return dq, dk, dv, None, None, None
