"""Packed-layout attention (counterpart of `msvit_tpu/ops/packed_attention.py`).

Multi-head self-attention that reads the QKV projection output in its GEMM
layout ``[B, N, 3*D]`` (q | k | v, each H heads x dh) and writes
``[B, N, D]`` ready for the output projection.  Two kernels, each a
hand-written CUDA kernel for Hopper with a plain PyTorch version beside it:

* `packed_attention` — K1, the TPU kernel `_packed_forward` (inference
  branch): the shaved softmax exp(clip(s, +-80)), bf16 or f32, optional
  bool/additive mask.  Kernel: `csrc/packed_attention.cu`; bf16 on the
  tensor cores, rounding p to bf16 into P.V and summing the rounded p as
  the TPU kernel does, f32 on the CUDA cores.
* `packed_attention_lse` — K1-lse, the same TPU kernel's `with_lse`
  branch, the training forward: the max-subtracted softmax plus a per-head
  lse [B, H, N] f32.  Kernel: `csrc/packed_attention_lse.cu` (bf16 on the
  tensor cores, f32 on the CUDA cores).
* `packed_attention_bwd` — K2, the TPU kernel `_packed_backward`: dqkv
  [B, N, 3D] from the saved (qkv, out, lse) and the output cotangent.
  Kernel: `csrc/packed_attention_bwd.cu`.
* `packed_attention_int8` — K3, the TPU kernel `packed_attention_int8`:
  int8 in, bf16 or int8 out.  Kernel: `csrc/packed_attention_int8.cu`, on
  the int8 tensor cores (s8 operands, s32 accumulators: both products
  exact), two passes over the keys (the exact row max, then the truncated
  probabilities into P.V).
* `packed_attention_int8_masked` — K9, the TPU kernel
  `_packed_int8_grouped`: K3 with a mask, the pre-scaled exp and the
  integer row sum (the multistate trunk's `attn_mode="int8"`).  Kernel: a
  second entry point of `csrc/packed_attention_int8.cu` (K3's kernel with
  the mask staged as a tile).  The TPU's head-pair grid and its VMEM gate
  (`int8_grouped_vmem_ok`) are not ported: the port takes any N.

K1, K1-lse and K2 also stand for the TPU's head-grouped functions, which
compute the same thing on a (B, H/2) grid for 512 to ~1100 tokens (the
unmasked ViT-B/8 at 785): K8a `_packed_forward_grouped` (its inference
branch is K1, its `with_lse` branch K1-lse) and K8b
`_packed_backward_grouped` (K2 with the dp panel through a VMEM scratch).
The head-pair grid, the scratch and the four `*_vmem_ok` gates are TPU
tiling: the port's kernels tile over N and take any length.  One deviation:
K8b reads an additive mask rounded to bf16 (exact for the model's 0 / -100
masks); K2 and its plain version read it in f32 at every N, as the TPU's
K2 and both forwards do.

Each wrapper takes the plain version for a tensor on the CPU, and for a
tensor on the card launches its kernel or raises: there is no fallback.
Each counts its kernel launches in a plain int attribute (`.launches`).

`packed_attention` splits as the JAX `custom_vjp` does: under autograd
(grad enabled and qkv requiring grad) it runs `PackedAttentionFunction`,
K1-lse forward and K2 backward, exact at any logit scale; otherwise K1.

Bounded-logit contract (K1 only, as on the TPU): scaled logits are
clamped to +-80 instead of having the row max subtracted; for |s| < 80 the
result is exact, larger logits are flattened toward uniform attention,
and a fully masked row gives mean(V).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from msvit_tpu_torch.ops import _build
from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dims(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    if qkv.ndim != 3:
        raise ValueError(f"qkv must be [B, N, 3*D]; got {tuple(qkv.shape)}")
    b, n, d3 = qkv.shape
    if d3 % 3:
        raise ValueError(f"last dim {d3} not 3*D")
    d = d3 // 3
    if d % num_heads:
        raise ValueError(f"D {d} not divisible by num_heads {num_heads}")
    return b, n, d, d // num_heads


def unpack_qkv(qkv: torch.Tensor, num_heads: int):
    """[B, N, 3D] -> q, k, v each [B, H, N, dh] (views)."""
    b, n, d, dh = _dims(qkv, num_heads)
    t = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H*dh]."""
    b, h, n, dh = o.shape
    return o.transpose(1, 2).reshape(b, n, h * dh)


def _check_cuda(
    x: torch.Tensor, name: str, dh: int, dtypes=tuple(_DTYPE_CODES)
) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if dh % 8 or dh > 128:
        raise ValueError(
            f"{name}: head size {dh} unsupported (a multiple of 8, <= 128)"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} unsupported")


def _check_mask_rank(mask: Optional[torch.Tensor]) -> None:
    if mask is not None and mask.ndim != 4:
        raise ValueError(f"mask must be [B, 1|H, N, N]; got {tuple(mask.shape)}")


def _mask_args(mask, qkv: torch.Tensor, num_heads: int, name: str,
               additive=torch.float32):
    """(kind, mask tensor, image stride, head stride) for the C entry
    points: kind 0 none, 1 bool (one byte per entry), 2 additive (in
    `additive`, f32 but for K9); strides in elements, 0 where the mask
    broadcasts."""
    if mask is None:
        return 0, None, 0, 0
    b, n = qkv.shape[:2]
    if (
        mask.shape[0] not in (1, b)
        or mask.shape[1] not in (1, num_heads)
        or tuple(mask.shape[2:]) != (n, n)
    ):
        raise ValueError(
            f"mask {tuple(mask.shape)} does not fit [B|1, 1|H, {n}, {n}]"
        )
    if mask.device != qkv.device:
        raise ValueError(f"{name}: mask on another device")
    if mask.dtype == torch.bool:
        kind, m = 1, mask.contiguous().view(torch.uint8)
    elif mask.is_floating_point():
        kind, m = 2, mask.to(additive).contiguous()
    else:
        raise TypeError(f"{name}: mask dtype {mask.dtype}")
    sb = m.stride(0) if m.shape[0] > 1 else 0
    sh = m.stride(1) if m.shape[1] > 1 else 0
    return kind, m, sb, sh


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the plain versions: f32, or f64 for f64
    inputs (so that `torch.autograd.gradcheck` can run them)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, scale, mask, mask_value, acc=torch.float32) -> torch.Tensor:
    """q.k^T in `acc`, times `scale`, the mask applied after the upcast."""
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, mask_value)
        else:
            s = s + mask.to(acc)
    return s


# ---------------------------------------------------------------- K1 ----


def packed_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Plain version of K1, the TPU kernel's arithmetic step for step:
    f32 scores, the mask applied after the upcast, p = exp(clip(s, +-80))
    rounded to qkv's dtype, P.V and the row sum of that rounded p in f32,
    then the division."""
    _, _, _, dh = _dims(qkv, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    q, k, v = unpack_qkv(qkv, num_heads)
    s = _scores(q, k, scale, mask, mask_value)
    pb = torch.exp(s.clamp(-80.0, 80.0)).to(qkv.dtype).float()
    o = torch.matmul(pb, v.float())
    out = o / pb.sum(-1, keepdim=True)
    return merge_heads(out.to(qkv.dtype))


def packed_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Self-attention over packed QKV.

    qkv: [B, N, 3*D] bf16 or f32, laid out [q | k | v] along the last dim.
    mask: optional [B|1, 1|H, N, N]; bool (True = attend) or additive float.
    scale: defaults to 1/sqrt(head_dim).
    Returns [B, N, D] in qkv's dtype.

    Under autograd (grad enabled and qkv requiring grad) this is
    `PackedAttentionFunction`: K1-lse forward, K2 backward.  Otherwise K1,
    the shaved inference softmax."""
    b, n, d, dh = _dims(qkv, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if torch.is_grad_enabled() and qkv.requires_grad:
        return PackedAttentionFunction.apply(
            qkv, mask, num_heads, float(scale), float(mask_value)
        )
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, num_heads, mask, scale, mask_value)
    _check_cuda(qkv, "packed_attention", dh)
    kind, m, sb, sh = _mask_args(mask, qkv, num_heads, "packed_attention")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.msvit_packed_attention(
            qkv.data_ptr(), _ptr(m), out.data_ptr(), _DTYPE_CODES[qkv.dtype],
            b, n, num_heads, dh, kind, sb, sh, float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, "packed_attention")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0


# ------------------------------------------------------------ K1-lse ----


def packed_attention_lse_plain(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1-lse, the TPU kernel's `with_lse` branch step for
    step: f32 scores, the mask after the upcast, m = row max, p = exp(s -
    m), l = sum p in f32, P.V with p rounded to qkv's dtype, o / l, and
    lse = m + log l.  Returns (out [B, N, D] in qkv's dtype, lse [B, H, N]
    f32; f64 for f64 inputs)."""
    _, _, _, dh = _dims(qkv, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    acc = _acc(qkv.dtype)
    q, k, v = unpack_qkv(qkv, num_heads)
    s = _scores(q, k, scale, mask, mask_value, acc)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # >= 1: the max entry
    o = torch.matmul(p.to(qkv.dtype).to(acc), v.to(acc)) / l
    return merge_heads(o.to(qkv.dtype)), (m + torch.log(l)).squeeze(-1)


def packed_attention_lse(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward over packed QKV (K1-lse): the max-subtracted
    softmax, exact at any logit scale.  Arguments as `packed_attention`.
    Returns (out [B, N, D] in qkv's dtype, lse [B, H, N] f32)."""
    b, n, d, dh = _dims(qkv, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if qkv.device.type == "cpu":
        return packed_attention_lse_plain(qkv, num_heads, mask, scale, mask_value)
    _check_cuda(qkv, "packed_attention_lse", dh)
    kind, m, sb, sh = _mask_args(mask, qkv, num_heads, "packed_attention_lse")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.msvit_packed_attention_lse(
            qkv.data_ptr(), _ptr(m), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[qkv.dtype], b, n, num_heads, dh, kind, sb, sh,
            float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, "packed_attention_lse")
    packed_attention_lse.launches += 1
    return out, lse


packed_attention_lse.launches = 0


# ---------------------------------------------------------------- K2 ----


def packed_attention_bwd_plain(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Plain version of K2, the TPU kernel `_kernel_packed_bwd` step for
    step: delta = sum(g*o) in f32; pb = exp(s - lse) rounded to qkv's
    dtype; dv = pb^T g; dp = g v^T; ds = pb*(dp - delta) rounded to qkv's
    dtype; dq = ds k * scale; dk = ds^T q * scale; dqkv packed q | k | v
    [B, N, 3D] in qkv's dtype (f64 inputs compute in f64)."""
    b, n, d, dh = _dims(qkv, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    dt, acc = qkv.dtype, _acc(qkv.dtype)
    q, k, v = unpack_qkv(qkv, num_heads)
    g4 = g.reshape(b, n, num_heads, dh).transpose(1, 2).to(acc)
    o4 = out.reshape(b, n, num_heads, dh).transpose(1, 2).to(acc)
    delta = (g4 * o4).sum(-1, keepdim=True)
    s = _scores(q, k, scale, mask, mask_value, acc)
    pb = torch.exp(s - lse.to(acc)[..., None]).to(dt).to(acc)
    dv = torch.matmul(pb.transpose(-1, -2), g4)
    dp = torch.matmul(g4, v.to(acc).transpose(-1, -2))
    ds = (pb * (dp - delta)).to(dt).to(acc)
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    if scale != 1.0:
        dq = dq * scale
        dk = dk * scale
    return torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], -1).to(dt)


def packed_attention_bwd(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Backward of the training forward (K2), from its residuals: qkv and
    mask as given to `packed_attention_lse`, its `out` and `lse`, and the
    cotangent `g` [B, N, D] of `out`.  Returns dqkv [B, N, 3D] in qkv's
    dtype.  Nothing flows to the mask, as in the JAX VJP."""
    b, n, d, dh = _dims(qkv, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if qkv.device.type == "cpu":
        return packed_attention_bwd_plain(
            qkv, mask, out, lse, g, num_heads, scale, mask_value
        )
    name = "packed_attention_bwd"
    _check_cuda(qkv, name, dh)
    if out.shape != (b, n, d) or g.shape != (b, n, d):
        raise ValueError(
            f"{name}: out {tuple(out.shape)} and g {tuple(g.shape)} must be "
            f"{(b, n, d)}"
        )
    if lse.shape != (b, num_heads, n):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} must be {(b, num_heads, n)}")
    out = out.to(qkv.dtype).contiguous()
    g = g.to(qkv.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    for t in (out, g, lse):
        if t.device != qkv.device:
            raise ValueError(f"{name}: residuals on another device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: out, g and lse must be 16-byte aligned")
    kind, m, sb, sh = _mask_args(mask, qkv, num_heads, name)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.msvit_packed_attention_bwd(
            qkv.data_ptr(), _ptr(m), out.data_ptr(), lse.data_ptr(),
            g.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
            _DTYPE_CODES[qkv.dtype], b, n, num_heads, dh, kind, sb, sh,
            float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    packed_attention_bwd.launches += 1
    return dqkv


packed_attention_bwd.launches = 0


class PackedAttentionFunction(torch.autograd.Function):
    """The JAX `_packed` custom VJP in its kernel regime: the forward is
    K1-lse and saves (qkv, mask, out, lse), the backward is K2.  On the
    CPU both run their plain versions.  Nothing flows to the mask or the
    non-tensor arguments."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads, scale, mask_value):
        out, lse = packed_attention_lse(qkv, num_heads, mask, scale, mask_value)
        ctx.save_for_backward(qkv, mask, out, lse)
        ctx.args = (num_heads, scale, mask_value)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, mask, out, lse = ctx.saved_tensors
        dqkv = packed_attention_bwd(qkv, mask, out, lse, g, *ctx.args)
        return dqkv, None, None, None, None


# ---------------------------------------------------------------- K3 ----


def _int8_scales(section_scales, out_inv_scale, device) -> torch.Tensor:
    """[s_q, s_k, s_v, inv_s_out] f32 on `device` (no host sync)."""
    sec = torch.as_tensor(section_scales, dtype=torch.float32, device=device)
    inv = (
        torch.zeros(1, dtype=torch.float32, device=device)
        if out_inv_scale is None
        else torch.as_tensor(out_inv_scale, dtype=torch.float32, device=device)
    )
    return torch.cat([sec.reshape(3), inv.reshape(1)])


def packed_attention_int8_plain(
    qkv_q: torch.Tensor,
    section_scales,
    num_heads: int,
    out_inv_scale=None,
    scale: Optional[float] = None,
    int8_out: bool = False,
) -> torch.Tensor:
    """Plain version of K3, the TPU kernel's arithmetic step for step.
    The integer products run as f32 matmuls on int8 values, exact while
    |sums| < 2^24 (N*127*127 for P.V: N up to 1040)."""
    _, _, _, dh = _dims(qkv_q, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    sc = _int8_scales(section_scales, out_inv_scale, qkv_q.device)
    s_q, s_k, s_v, inv = sc[0], sc[1], sc[2], sc[3]
    q, k, v = unpack_qkv(qkv_q, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        (scale * s_q) * s_k
    )
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pq = (p * 127.0).to(torch.int8)  # truncating, as on the TPU
    o = torch.matmul(pq.float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = o * (s_v / 127.0) / l
    if int8_out:
        o = torch.clamp(torch.round(o * inv), -127, 127).to(torch.int8)
    else:
        o = o.to(torch.bfloat16)
    return merge_heads(o)


def packed_attention_int8(
    qkv_q: torch.Tensor,
    section_scales,
    num_heads: int,
    out_inv_scale=None,
    scale: Optional[float] = None,
    int8_out: bool = False,
) -> torch.Tensor:
    """Fully-int8 packed self-attention for serving (K3).

    qkv_q: [B, N, 3*D] int8 (per-section quantized GEMM output).
    section_scales: [3] f32 dequant scales of q | k | v.
    out_inv_scale: scalar f32, the inverse output scale for ``int8_out``.
    Returns [B, N, D] bf16, or int8 when ``int8_out``.  No mask, no VJP."""
    b, n, d, dh = _dims(qkv_q, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    if qkv_q.device.type == "cpu":
        return packed_attention_int8_plain(
            qkv_q, section_scales, num_heads, out_inv_scale, scale, int8_out
        )
    _check_cuda(qkv_q, "packed_attention_int8", dh, dtypes=(torch.int8,))
    sc = _int8_scales(section_scales, out_inv_scale, qkv_q.device)
    out = torch.empty(
        (b, n, d), dtype=torch.int8 if int8_out else torch.bfloat16,
        device=qkv_q.device,
    )
    lib = _build.library()
    with torch.cuda.device(qkv_q.device):
        code = lib.msvit_packed_attention_int8(
            qkv_q.data_ptr(), sc.data_ptr(), out.data_ptr(), int(int8_out),
            b, n, num_heads, dh, float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, "packed_attention_int8")
    packed_attention_int8.launches += 1
    return out


packed_attention_int8.launches = 0


# ---------------------------------------------------------------- K9 ----

# log(127): exp(s - max + _LN127) = 127 p, as the TPU kernel's constant
_LN127 = 4.8441870864585885


def packed_attention_int8_masked_plain(
    qkv_q: torch.Tensor,
    section_scales,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    out_inv_scale=None,
    scale: Optional[float] = None,
    int8_out: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Plain version of K9, the TPU kernel `_kernel_int8_grouped` step for
    step: int scores times (scale * s_q) * s_k in f32; a bool mask
    where-valid with `mask_value`, an additive one rounded to bf16 and
    added; m = row max; pq = trunc(exp(s - m + ln 127)); l = sum pq floored
    at 1; o = (pq . v) * (s_v / l), bf16 or int8 out.  The integer product
    runs in f64, exact at any N."""
    _, _, _, dh = _dims(qkv_q, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    sc = _int8_scales(section_scales, out_inv_scale, qkv_q.device)
    s_q, s_k, s_v, inv = sc[0], sc[1], sc[2], sc[3]
    q, k, v = unpack_qkv(qkv_q, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * ((scale * s_q) * s_k)
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, mask_value)
        else:
            s = s + mask.to(torch.bfloat16).float()
    pq = torch.exp(s - s.amax(-1, keepdim=True) + _LN127).to(torch.int8)  # truncating
    o = torch.matmul(pq.double(), v.double()).float()
    l = pq.float().sum(-1, keepdim=True).clamp_min(1.0)
    o = o * (s_v / l)
    if int8_out:
        o = torch.clamp(torch.round(o * inv), -127, 127).to(torch.int8)
    else:
        o = o.to(torch.bfloat16)
    return merge_heads(o)


def packed_attention_int8_masked(
    qkv_q: torch.Tensor,
    section_scales,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    out_inv_scale=None,
    scale: Optional[float] = None,
    int8_out: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Fully-int8 packed self-attention with a mask, for serving (K9).

    qkv_q: [B, N, 3*D] int8 (per-section quantized GEMM output).
    section_scales: [3] f32 dequant scales of q | k | v.
    mask: optional [B|1, 1|H, N, N], bool (True = attend) or additive (read
    as bf16, as on the TPU).
    out_inv_scale: scalar f32, the inverse output scale for ``int8_out``.
    Returns [B, N, D] bf16, or int8 when ``int8_out``.  No VJP."""
    b, n, d, dh = _dims(qkv_q, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if qkv_q.device.type == "cpu":
        return packed_attention_int8_masked_plain(
            qkv_q, section_scales, num_heads, mask, out_inv_scale, scale, int8_out,
            mask_value)
    name = "packed_attention_int8_masked"
    _check_cuda(qkv_q, name, dh, dtypes=(torch.int8,))
    kind, m, sb, sh = _mask_args(mask, qkv_q, num_heads, name, additive=torch.bfloat16)
    sc = _int8_scales(section_scales, out_inv_scale, qkv_q.device)
    out = torch.empty(
        (b, n, d), dtype=torch.int8 if int8_out else torch.bfloat16,
        device=qkv_q.device,
    )
    lib = _build.library()
    with torch.cuda.device(qkv_q.device):
        code = lib.msvit_packed_attention_int8_masked(
            qkv_q.data_ptr(), sc.data_ptr(), _ptr(m), out.data_ptr(), int(int8_out),
            b, n, num_heads, dh, kind, sb, sh, float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    packed_attention_int8_masked.launches += 1
    return out


packed_attention_int8_masked.launches = 0
