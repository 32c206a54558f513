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

K1, K1-lse and K2 (and K4, K5, K5-lse, K6, K7, K7-lse and K10,
`ops/fused_attention.py`, `ops/flash_attention.py`,
`ops/banded_attention.py`) take one of three routes, by `kernel_route`
(the C entry points apply the same rule): bf16 at head size 64 (every zoo
trunk but vit-h14) the Hopper kernels on `wgmma` fed by TMA, other bf16
head sizes the `mma.sync` kernels, f32 the CUDA cores.  Each wrapper
counts its launches by route beside `.launches` (`.wgmma_launches`,
`.mma_launches`, `.f32_launches`; `route_counts`).  K1-lse's and K2's TMA
maps are 3-D over the packed tensors (`tma_map`), those of K1, K4, K5, K6,
K7 and K10 4-D over [B, H, N, 64] views (`tma_map_heads`; K1 and K10 read
the packed qkv's q, k and v views): a q, k or v whose base or pitches TMA
cannot take raises a `ValueError`; it never takes another route.  K6's
cotangent alone is copied where TMA cannot take it (`tma_heads_operand`).
* `packed_attention_int8` — K3, the TPU kernel `packed_attention_int8`:
  int8 in, bf16 or int8 out.  Kernel: `csrc/packed_attention_int8.cu`, on
  the int8 tensor cores (s8 operands, s32 accumulators: both products
  exact), two passes over the keys (the exact row max, then the truncated
  probabilities into P.V).
* `packed_attention_int8_masked` — K9, the TPU kernel
  `_packed_int8_grouped`: K3 with a mask, the pre-scaled exp and the
  integer row sum (the multistate trunk's `attn_mode="int8"`).  Kernel: a
  second entry point of `csrc/packed_attention_int8.cu`.  The TPU's
  head-pair grid and its VMEM gate (`int8_grouped_vmem_ok`) are not
  ported: the port takes any N.

K3 and K9 take one of two routes, by `int8_kernel_route`: head size 64 the
Hopper kernel on s8 `wgmma` fed by TMA (`csrc/attention_int8_wgmma.cuh`),
other head sizes the `mma.sync` kernel.  Both count their launches by route
(`route_counts()["K3"]`, `["K9"]`).  The wgmma route's TMA map is 3-D over
the packed int8 qkv with a 64-byte swizzle (`tma_map_int8`): a qkv whose
base or pitch TMA cannot take raises a `ValueError`.  K9's mask rides the
same ring by TMA (`int8_mask_operand` pads the wrapper's copy of it where N
needs it).  P.V's V^T is written in the key order of `int8_pv_key_order`.

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

K1 (the inference branch of `packed_attention`), K3 and K9 are registered
ops, `torch.ops.msvit.packed_attention`, `torch.ops.msvit.packed_attention_int8`
and `torch.ops.msvit.packed_attention_int8_masked`
(`torch.library.custom_op`, each with a fake implementation that gives the
output's shape and dtype), so that `torch.export` keeps each as one node of
the graph and a reloaded program calls the same kernel (`export.py`).  The
host work of a launch (checks, the ctypes call, the count) sits inside the
op, where a trace does not reach.  Under a trace or a dispatch mode the
wrappers call the registered op; a plain call runs the op's body directly
and skips the dispatcher's host cost, which a host-bound lone request pays
on every layer (`chip_smoke.dispatch_ab` measures both).

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


# ---------------------------------------------------- kernel routes ----

ROUTES = ("wgmma", "mma.sync", "cuda_cores")
_ROUTE_COUNTERS = {"wgmma": "wgmma_launches", "mma.sync": "mma_launches",
                   "cuda_cores": "f32_launches"}
TMA_BOX = (64, 64, 1)  # (head elements, rows, images) of one tile
TMA_BOX_HEADS = (64, 64, 1, 1)  # (head elements, rows, heads, images)


def kernel_route(dtype: torch.dtype, dh: int) -> str:
    """The kernel route of K1, K1-lse, K2, K4, K5, K5-lse, K6, K7, K7-lse
    and K10 on the card:
    "wgmma" (bf16, head size 64: warpgroup products fed by TMA),
    "mma.sync" (bf16, any other head size: the head padded to its
    16/32/64/128 bucket) or "cuda_cores" (f32).  The C entry points take
    the same rule."""
    if dtype == torch.float32:
        return "cuda_cores"
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype} unsupported (f32 or bf16)")
    if dh % 8 or not 0 < dh <= 128:
        raise ValueError(f"head size {dh} unsupported (a multiple of 8, <= 128)")
    return "wgmma" if dh == 64 else "mma.sync"


def tma_map(shape, element_size: int, data_ptr: int) -> dict:
    """The geometry of the 3-D TMA map the wgmma kernels build over a
    packed row-major tensor of `shape` [B, N, W] (qkv: W = 3D, g: W = D):
    dims (W, N, B) innermost first, pitches in bytes (W e, N W e), the box
    `TMA_BOX`, a 128-byte swizzle (one 64-element bf16 row); rows past N
    are zero-filled inside their image.  Raises `ValueError` where TMA
    cannot take the tensor: a base off 16 bytes, a pitch that is not a
    multiple of 16 bytes."""
    b, n, w = shape
    pitch = w * element_size
    if data_ptr % 16:
        raise ValueError(f"TMA: the tensor's base {data_ptr:#x} is not 16-byte aligned")
    if pitch % 16:
        raise ValueError(f"TMA: row pitch {pitch} bytes ([{b}, {n}, {w}]) is not a "
                         f"multiple of 16")
    return {"dims": (w, n, b), "pitches": (pitch, pitch * n), "box": TMA_BOX,
            "box_bytes": TMA_BOX[0] * TMA_BOX[1] * element_size}


def _tma_heads_geometry(shape, strides, element_size: int, data_ptr: int):
    """(dims, pitches, refusal) of the 4-D TMA map of `tma_map_heads`:
    refusal is None where TMA takes the view, else the reason it does not."""
    b, h, n, dh = shape
    sb, sh, sn, se = strides
    if n == 1:
        sn = dh
    if h == 1:
        sh = sn * n
    if b == 1:
        sb = sh * h
    pitches = tuple(s * element_size for s in (sn, sh, sb))
    refusal = None
    if se != 1:
        refusal = f"TMA: the head's elements are {se} apart, not contiguous"
    elif data_ptr % 16:
        refusal = f"TMA: the view's base {data_ptr:#x} is not 16-byte aligned"
    else:
        for what, p in zip(("row", "head", "image"), pitches):
            if p <= 0 or p % 16:
                refusal = (f"TMA: {what} pitch {p} bytes ({tuple(shape)} strides "
                           f"{tuple(strides)}) is not a positive multiple of 16")
                break
    return (dh, n, h, b), pitches, refusal


def tma_map_heads(shape, strides, element_size: int, data_ptr: int) -> dict:
    """The geometry of the 4-D TMA map the wgmma kernels of K1, K5, K7 and
    K6 build over a [B, H, N, 64] view of `shape` and element `strides`
    (`csrc/hopper.cuh::map_heads`): dims (64, N, H, B) innermost first,
    pitches in bytes of a row, a head and an image, the box
    `TMA_BOX_HEADS`, a 128-byte swizzle; rows past N are zero-filled inside
    their (head, image).  A dim of size 1 is never stepped: it takes the
    pitch of the dim below it times that dim's size.  Raises `ValueError`
    where TMA cannot take the view: the head's elements not contiguous, a
    base off 16 bytes, a stepped pitch that is not a positive multiple of
    16 bytes."""
    dims, pitches, refusal = _tma_heads_geometry(shape, strides, element_size, data_ptr)
    if refusal is not None:
        raise ValueError(refusal)
    return {"dims": dims, "pitches": pitches, "box": TMA_BOX_HEADS,
            "box_bytes": TMA_BOX_HEADS[0] * TMA_BOX_HEADS[1] * element_size}


def tma_heads_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` where the 4-D TMA map of `tma_map_heads` takes it as it is, else
    a fresh contiguous copy, which it always takes: K6's cotangent, which
    autograd can hand over expanded (the gradient of ``(out * w).sum()``,
    strides (0, 0, 0, 1): pitch 0) or at a pitch off 16 bytes.  Only the
    cotangent is copied; q, k and v views that TMA cannot take raise
    (`check_tma_heads`)."""
    if _tma_heads_geometry(t.shape, t.stride(), t.element_size(), t.data_ptr())[2] is None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def int8_kernel_route(dh: int) -> str:
    """The kernel route of K3 and K9 on the card: "wgmma" at head size 64
    (s8 warpgroup products fed by TMA), "mma.sync" at any other head size
    that is a multiple of 8 and at most 128.  The C entry points take the
    same rule."""
    if dh % 8 or not 0 < dh <= 128:
        raise ValueError(f"head size {dh} unsupported (a multiple of 8, <= 128)")
    return "wgmma" if dh == 64 else "mma.sync"


TMA_BOX_S8 = (64, 64, 1)  # (head bytes, rows, images) of one int8 tile
TMA_SWIZZLE_S8 = 64  # bytes: one 64-byte s8 head row


def tma_map_int8(shape, data_ptr: int) -> dict:
    """The geometry of the 3-D TMA map the int8 wgmma kernel (K3, K9 at
    head size 64) builds over a packed int8 [B, N, W] qkv (W = 3D;
    `csrc/hopper.cuh::map_rows_s8`): dims (W, N, B) innermost first,
    pitches in bytes (W, N W), the box `TMA_BOX_S8` (one head's 64 bytes of
    64 rows), a 64-byte swizzle; rows past N are zero-filled inside their
    image.  Raises `ValueError` where TMA cannot take the tensor: a base off
    16 bytes, a row pitch that is not a multiple of 16 bytes."""
    b, n, w = shape
    if data_ptr % 16:
        raise ValueError(f"TMA: the tensor's base {data_ptr:#x} is not 16-byte aligned")
    if w % 16:
        raise ValueError(f"TMA: row pitch {w} bytes ([{b}, {n}, {w}] int8) is not a "
                         f"multiple of 16")
    return {"dims": (w, n, b), "pitches": (w, w * n), "box": TMA_BOX_S8,
            "box_bytes": TMA_BOX_S8[0] * TMA_BOX_S8[1], "swizzle": TMA_SWIZZLE_S8}


def int8_mask_operand(m: torch.Tensor) -> torch.Tensor:
    """K9's mask on the wgmma route as its TMA map reads it (`csrc/hopper.cuh::
    map_mask`): `m` ([B|1, 1|H, N, N] contiguous, bool bytes as uint8 or
    bf16) where its base is on 16 bytes and its rows are a multiple of 16
    bytes, else a copy of it whose rows are zero-padded to the next multiple
    of 16 bytes (N % 8 != 0 in bf16, N % 16 != 0 in bool): the kernel reads
    it through its row stride and never past key N."""
    n = m.shape[-1]
    step = 16 // m.element_size()
    if m.data_ptr() % 16 == 0 and n % step == 0:
        return m
    padded = m.new_zeros(*m.shape[:-1], -(-n // step) * step)
    padded[..., :n] = m
    return padded


def int8_pv_key_order() -> Tuple[int, ...]:
    """The keys of one 32-key k-step of the int8 wgmma kernel's P.V, by
    logical position: position 4t + i of the s8 A fragment holds key
    (2t, 2t+1, 8+2t, 9+2t)[i] and position 16 + 4t + i key 16 + the same,
    because each lane (g, t) packs its own s32 accumulator values (keys
    8j+2t, 8j+2t+1) with no shuffle; V^T's bytes of each head column are
    written in the same order (`csrc/attention_int8_wgmma.cuh::
    int8_transpose_v`), so the product over keys is P.V exactly."""
    half = [k for t in range(4) for k in (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)]
    return tuple(half + [16 + k for k in half])


def head_columns(num_heads: int, h: int, dh: int = 64) -> Tuple[int, int, int]:
    """The first element column of head h's q, k and v boxes in a packed
    [B, N, 3D] row (D = num_heads * dh): h dh, D + h dh, 2D + h dh."""
    d = num_heads * dh
    return h * dh, d + h * dh, 2 * d + h * dh


def _count_route(fn, route: str) -> None:
    fn.launches += 1
    name = _ROUTE_COUNTERS[route]
    setattr(fn, name, getattr(fn, name) + 1)


def zero_counts(*fns) -> None:
    """Set each wrapper's launch count, and its counts by route, to 0."""
    for fn in fns:
        fn.launches = 0
        for name in _ROUTE_COUNTERS.values():
            setattr(fn, name, 0)


def routes_of(fn) -> dict:
    """{route: launches} of a wrapper since its counts were set to 0."""
    return {r: getattr(fn, _ROUTE_COUNTERS[r]) for r in ROUTES}


def _routed() -> dict:
    """The wrappers that count their launches by route, by kernel."""
    from msvit_tpu_torch.ops.banded_attention import token_rows
    from msvit_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_lse)
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference, fused_attention_lse)

    return {"K1": packed_attention, "K1-lse": packed_attention_lse,
            "K2": packed_attention_bwd, "K3": packed_attention_int8,
            "K4": fused_attention_inference,
            "K5": fused_attention, "K5-lse": fused_attention_lse,
            "K6": flash_attention_bwd, "K7": flash_attention,
            "K7-lse": flash_attention_lse, "K9": packed_attention_int8_masked,
            "K10": token_rows}


def route_counts() -> dict:
    """{"K1": {route: launches}, "K1-lse": ..., "K2", "K3", "K4", "K5",
    "K5-lse", "K6", "K7", "K7-lse", "K9", "K10"} since each wrapper's
    `zero_counts`."""
    return {k: routes_of(fn) for k, fn in _routed().items()}


def _check_tma(name: str, *tensors: torch.Tensor) -> None:
    """K1-lse's and K2's 3-D TMA maps over packed operands: every one
    must map."""
    for t in tensors:
        try:
            tma_map(t.shape, t.element_size(), t.data_ptr())
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None


def check_tma_heads(name: str, *views: torch.Tensor) -> None:
    """The 4-D TMA maps of K1, K4, K5, K6, K7 and K10: every
    [B, H, N, 64] view must map."""
    for t in views:
        try:
            tma_map_heads(t.shape, t.stride(), t.element_size(), t.data_ptr())
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None


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


def _traced(x: torch.Tensor) -> bool:
    """Whether a wrapper call is traced (`torch.export`, `torch.compile`:
    fake or functional tensors) or runs under a dispatch mode
    (`FlopCounterMode`): then it goes through the registered op, which the
    trace keeps as one node and the mode sees."""
    return (type(x) is not torch.Tensor or torch.compiler.is_compiling()
            or torch._C._len_torch_dispatch_stack() > 0)


def _off_kernel_devices(x: torch.Tensor, name: str) -> None:
    """A registered op sends a meta tensor to its fake implementation;
    outside tracing, a tensor that is neither on the CPU nor on the card
    has no kernel (as the other wrappers say through `_check_cuda`)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for tensors on {x.device}")


def _packed_attention_k1(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    mask_value: float,
) -> torch.Tensor:
    """K1, the body of the registered op `torch.ops.msvit.packed_attention`:
    the plain version on the CPU, the kernel on the card (or an
    exception)."""
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, num_heads, mask, scale, mask_value)
    b, n, d, dh = _dims(qkv, num_heads)
    _check_cuda(qkv, "packed_attention", dh)
    route = kernel_route(qkv.dtype, dh)
    if route == "wgmma":
        check_tma_heads("packed_attention", *unpack_qkv(qkv, num_heads))
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
    _count_route(packed_attention, route)
    return out


_packed_attention_op = torch.library.custom_op(
    "msvit::packed_attention", _packed_attention_k1, mutates_args=())


@_packed_attention_op.register_fake
def _(qkv, mask, num_heads, scale, mask_value):
    b, n, d3 = qkv.shape
    return qkv.new_empty((b, n, d3 // 3))


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
    the shaved inference softmax (through the registered op
    `torch.ops.msvit.packed_attention` when traced)."""
    b, n, d, dh = _dims(qkv, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if torch.is_grad_enabled() and qkv.requires_grad:
        return PackedAttentionFunction.apply(
            qkv, mask, num_heads, float(scale), float(mask_value)
        )
    if not _traced(qkv):
        return _packed_attention_k1(qkv, mask, num_heads, float(scale), float(mask_value))
    _off_kernel_devices(qkv, "packed_attention")
    return torch.ops.msvit.packed_attention(
        qkv, mask, num_heads, float(scale), float(mask_value))


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
    route = kernel_route(qkv.dtype, dh)
    if route == "wgmma":
        _check_tma("packed_attention_lse", qkv)
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
    _count_route(packed_attention_lse, route)
    return out, lse


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
    route = kernel_route(qkv.dtype, dh)
    if route == "wgmma":
        _check_tma(name, qkv, g)
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
    _count_route(packed_attention_bwd, route)
    return dqkv


zero_counts(packed_attention, packed_attention_lse, packed_attention_bwd)


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


def _check_int8_route(name: str, qkv_q: torch.Tensor, dh: int) -> str:
    """K3's and K9's route for a qkv_q on the card; on the wgmma route its
    TMA map must take it (`tma_map_int8`: a `ValueError` otherwise, never
    a copy)."""
    route = int8_kernel_route(dh)
    if route == "wgmma":
        try:
            tma_map_int8(qkv_q.shape, qkv_q.data_ptr())
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    return route


def _packed_attention_k3(
    qkv_q: torch.Tensor,
    section_scales: torch.Tensor,
    out_inv_scale: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    int8_out: bool,
) -> torch.Tensor:
    """K3, the body of the registered op
    `torch.ops.msvit.packed_attention_int8`: the plain version on the CPU,
    the kernel on the card (or an exception).  The scales are gathered on
    the device here, inside the op, so that a traced graph holds no device
    constant of them."""
    if qkv_q.device.type == "cpu":
        return packed_attention_int8_plain(
            qkv_q, section_scales, num_heads, out_inv_scale, scale, int8_out
        )
    b, n, d, dh = _dims(qkv_q, num_heads)
    _check_cuda(qkv_q, "packed_attention_int8", dh, dtypes=(torch.int8,))
    route = _check_int8_route("packed_attention_int8", qkv_q, dh)
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
    _count_route(packed_attention_int8, route)
    return out


_packed_attention_int8_op = torch.library.custom_op(
    "msvit::packed_attention_int8", _packed_attention_k3, mutates_args=())


@_packed_attention_int8_op.register_fake
def _(qkv_q, section_scales, out_inv_scale, num_heads, scale, int8_out):
    b, n, d3 = qkv_q.shape
    return qkv_q.new_empty((b, n, d3 // 3),
                           dtype=torch.int8 if int8_out else torch.bfloat16)


def _scale_tensor(x, device) -> Optional[torch.Tensor]:
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def packed_attention_int8(
    qkv_q: torch.Tensor,
    section_scales,
    num_heads: int,
    out_inv_scale=None,
    scale: Optional[float] = None,
    int8_out: bool = False,
) -> torch.Tensor:
    """Fully-int8 packed self-attention for serving (K3; through the
    registered op `torch.ops.msvit.packed_attention_int8` when traced).

    qkv_q: [B, N, 3*D] int8 (per-section quantized GEMM output).
    section_scales: [3] f32 dequant scales of q | k | v.
    out_inv_scale: scalar f32, the inverse output scale for ``int8_out``.
    Returns [B, N, D] bf16, or int8 when ``int8_out``.  No mask, no VJP."""
    _, _, _, dh = _dims(qkv_q, num_heads)
    if scale is None:
        scale = 1.0 / dh**0.5
    if not _traced(qkv_q):
        return _packed_attention_k3(qkv_q, section_scales, out_inv_scale, num_heads,
                                    float(scale), bool(int8_out))
    _off_kernel_devices(qkv_q, "packed_attention_int8")
    return torch.ops.msvit.packed_attention_int8(
        qkv_q, _scale_tensor(section_scales, qkv_q.device),
        _scale_tensor(out_inv_scale, qkv_q.device), num_heads, float(scale),
        bool(int8_out))


zero_counts(packed_attention_int8)


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


def _packed_attention_k9(
    qkv_q: torch.Tensor,
    section_scales: torch.Tensor,
    mask: Optional[torch.Tensor],
    out_inv_scale: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    int8_out: bool,
    mask_value: float,
) -> torch.Tensor:
    """K9, the body of the registered op
    `torch.ops.msvit.packed_attention_int8_masked`: the plain version on the
    CPU, the kernel on the card (or an exception); the scales gathered on
    the device inside the op, as K3's."""
    if qkv_q.device.type == "cpu":
        return packed_attention_int8_masked_plain(
            qkv_q, section_scales, num_heads, mask, out_inv_scale, scale, int8_out,
            mask_value)
    b, n, d, dh = _dims(qkv_q, num_heads)
    name = "packed_attention_int8_masked"
    _check_cuda(qkv_q, name, dh, dtypes=(torch.int8,))
    route = _check_int8_route(name, qkv_q, dh)
    kind, m, sb, sh = _mask_args(mask, qkv_q, num_heads, name, additive=torch.bfloat16)
    sr = n
    if m is not None and route == "wgmma":
        m = int8_mask_operand(m)
        sr = m.stride(2)
        sb = m.stride(0) if m.shape[0] > 1 else 0
        sh = m.stride(1) if m.shape[1] > 1 else 0
    sc = _int8_scales(section_scales, out_inv_scale, qkv_q.device)
    out = torch.empty(
        (b, n, d), dtype=torch.int8 if int8_out else torch.bfloat16,
        device=qkv_q.device,
    )
    lib = _build.library()
    with torch.cuda.device(qkv_q.device):
        code = lib.msvit_packed_attention_int8_masked(
            qkv_q.data_ptr(), sc.data_ptr(), _ptr(m), out.data_ptr(), int(int8_out),
            b, n, num_heads, dh, kind, sb, sh, sr, float(scale), float(mask_value),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    _count_route(packed_attention_int8_masked, route)
    return out


_packed_attention_int8_masked_op = torch.library.custom_op(
    "msvit::packed_attention_int8_masked", _packed_attention_k9, mutates_args=())


@_packed_attention_int8_masked_op.register_fake
def _(qkv_q, section_scales, mask, out_inv_scale, num_heads, scale, int8_out, mask_value):
    b, n, d3 = qkv_q.shape
    return qkv_q.new_empty((b, n, d3 // 3),
                           dtype=torch.int8 if int8_out else torch.bfloat16)


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
    """Fully-int8 packed self-attention with a mask, for serving (K9;
    through the registered op `torch.ops.msvit.packed_attention_int8_masked`
    when traced).

    qkv_q: [B, N, 3*D] int8 (per-section quantized GEMM output).
    section_scales: [3] f32 dequant scales of q | k | v.
    mask: optional [B|1, 1|H, N, N], bool (True = attend) or additive (read
    as bf16, as on the TPU).
    out_inv_scale: scalar f32, the inverse output scale for ``int8_out``.
    Returns [B, N, D] bf16, or int8 when ``int8_out``.  No VJP."""
    _, _, _, dh = _dims(qkv_q, num_heads)
    _check_mask_rank(mask)
    if scale is None:
        scale = 1.0 / dh**0.5
    if not _traced(qkv_q):
        return _packed_attention_k9(qkv_q, section_scales, mask, out_inv_scale, num_heads,
                                    float(scale), bool(int8_out), float(mask_value))
    _off_kernel_devices(qkv_q, "packed_attention_int8_masked")
    return torch.ops.msvit.packed_attention_int8_masked(
        qkv_q, _scale_tensor(section_scales, qkv_q.device), mask,
        _scale_tensor(out_inv_scale, qkv_q.device), num_heads, float(scale),
        bool(int8_out), float(mask_value))


zero_counts(packed_attention_int8_masked)
