"""Packed-layout attention (counterpart of `msvit_tpu/ops/packed_attention.py`).

Multi-head self-attention that reads the QKV projection output in its GEMM
layout ``[B, N, 3*D]`` (q | k | v, each H heads x dh) and writes
``[B, N, D]`` ready for the output projection.  Two kernels, each a
hand-written CUDA kernel for Hopper with a plain PyTorch version beside it:

* `packed_attention` — K1, the TPU kernel `_packed_forward` (inference
  branch): the shaved softmax exp(clip(s, +-80)), bf16 or f32, optional
  bool/additive mask.  Kernel: `csrc/packed_attention.cu`.
* `packed_attention_int8` — K3, the TPU kernel `packed_attention_int8`:
  int8 in, bf16 or int8 out.  Kernel: `csrc/packed_attention_int8.cu`.

Each wrapper takes the plain version for a tensor on the CPU, and for a
tensor on the card launches its kernel or raises: there is no fallback.
Each counts its kernel launches in a plain int attribute (`.launches`).

Bounded-logit contract (K1, as on the TPU): scaled logits are clamped to
+-80 instead of having the row max subtracted; for |s| < 80 the result is
exact, larger logits are flattened toward uniform attention, and a fully
masked row gives mean(V).  Training (the `with_lse` forward and its
backward, K2) is not ported: a CUDA input that requires grad raises.
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


def _check_cuda(x: torch.Tensor, name: str, dh: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name}: the training forward (K1 with_lse) and backward (K2) "
            "are not ported yet (ROADMAP.md queue 1, item 4); run inference "
            "under torch.inference_mode()"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if dh % 8 or dh > 128:
        raise ValueError(
            f"{name}: head size {dh} unsupported (a multiple of 8, <= 128)"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")


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
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, mask_value)
        else:
            s = s + mask.float()
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
    """Self-attention over packed QKV (K1, inference).

    qkv: [B, N, 3*D] bf16 or f32, laid out [q | k | v] along the last dim.
    mask: optional [B|1, 1|H, N, N]; bool (True = attend) or additive float.
    scale: defaults to 1/sqrt(head_dim).
    Returns [B, N, D] in qkv's dtype."""
    b, n, d, dh = _dims(qkv, num_heads)
    if mask is not None and mask.ndim != 4:
        raise ValueError(f"mask must be [B, 1|H, N, N]; got {tuple(mask.shape)}")
    if scale is None:
        scale = 1.0 / dh**0.5
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, num_heads, mask, scale, mask_value)
    _check_cuda(qkv, "packed_attention", dh)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"packed_attention: dtype {qkv.dtype} unsupported")
    kind, m, sb, sh = 0, None, 0, 0
    if mask is not None:
        if (
            mask.shape[0] not in (1, b)
            or mask.shape[1] not in (1, num_heads)
            or tuple(mask.shape[2:]) != (n, n)
        ):
            raise ValueError(
                f"mask {tuple(mask.shape)} does not fit [B|1, 1|H, {n}, {n}]"
            )
        if mask.device != qkv.device:
            raise ValueError("packed_attention: mask on another device")
        if mask.dtype == torch.bool:
            kind, m = 1, mask.contiguous().view(torch.uint8)
        elif mask.is_floating_point():
            kind, m = 2, mask.to(torch.float32).contiguous()
        else:
            raise TypeError(f"packed_attention: mask dtype {mask.dtype}")
        sb = m.stride(0) if m.shape[0] > 1 else 0
        sh = m.stride(1) if m.shape[1] > 1 else 0
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.msvit_packed_attention(
            qkv.data_ptr(), None if m is None else m.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[qkv.dtype], b, n, num_heads, dh,
            kind, sb, sh, float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, "packed_attention")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0


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
    _check_cuda(qkv_q, "packed_attention_int8", dh)
    if qkv_q.dtype != torch.int8:
        raise TypeError(f"packed_attention_int8: dtype {qkv_q.dtype}, want int8")
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
