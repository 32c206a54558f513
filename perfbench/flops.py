"""Operation and byte counts, and the published peaks they are held to.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): bf16
989 TFLOP/s, int8 1,979 TOP/s, float32 outside the tensor cores 67
TFLOP/s, HBM3 3.35 TB/s.  A matrix product of [M, K] by [K, N] is 2 M K N
operations; one attention head of Nq queries over Nk keys at head size dh
is 2 products of 2 Nq Nk dh.  A roofline's least time reads each input
once and writes each output once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Dict, Iterable

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BYTES = {"bf16": 2, "int8": 1, "f32": 4}


def vit_forward_ops(cfg: Dict, tokens: int, patches: int) -> float:
    """Operations of one image's forward through the trunk: the patch
    projection, then per layer the QKV, output, fc1 and fc2 products at
    `tokens` rows (CLS, cluster slots and patches alike) and attention at
    4 N^2 D."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    f = cfg["intermediate_size"]
    p, c = cfg["patch_size"], cfg["num_channels"]
    n = tokens
    gemms = 2 * patches * p * p * c * d + layers * (
        2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * f)
    return float(gemms + layers * 4 * n * n * d)


def attention_ops(b: int, h: int, nq: int, nk: int, dh: int) -> float:
    """Both products of attention: 4 B H Nq Nk dh."""
    return 4.0 * b * h * nq * nk * dh


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The roofline's least time: the larger of operations over the dtype's
    peak and bytes over the HBM bandwidth."""
    return max(ops / PEAK_OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def packed_attention_call(b: int, n: int, h: int, dh: int, dtype: str,
                          out_dtype: str) -> Dict[str, float]:
    """A packed self-attention call: reads qkv [B, N, 3 H dh], writes
    out [B, N, H dh]."""
    nbytes = b * n * 3 * h * dh * BYTES[dtype] + b * n * h * dh * BYTES[out_dtype]
    return {"ops": attention_ops(b, h, n, n, dh), "bytes": float(nbytes), "dtype": dtype}


def masked_attention_call(b: int, n: int, h: int, dh: int, dtype: str,
                          mask_heads: int, mask_dtype: str) -> Dict[str, float]:
    """A masked attention call: reads q, k, v [B, H, N, dh] and the additive
    mask [B, mask_heads, N, N], writes out [B, H, N, dh]."""
    nbytes = (4 * b * h * n * dh * BYTES[dtype]
              + b * mask_heads * n * n * BYTES[mask_dtype])
    return {"ops": attention_ops(b, h, n, n, dh), "bytes": float(nbytes), "dtype": dtype}


def calls_least_seconds(calls: Iterable[Dict[str, float]]) -> float:
    return sum(least_seconds(c["ops"], c["bytes"], c["dtype"]) for c in calls)


def packed_attention_lse_call(b: int, n: int, h: int, dh: int) -> Dict[str, float]:
    """The training forward (K1-lse): reads qkv [B, N, 3 H dh] bf16, writes
    out [B, N, H dh] bf16 and the f32 log-sum-exp [B, H, N]."""
    nbytes = 2 * (b * n * 3 * h * dh + b * n * h * dh) + 4 * b * h * n
    return {"ops": attention_ops(b, h, n, n, dh), "bytes": float(nbytes), "dtype": "bf16"}


def packed_attention_bwd_call(b: int, n: int, h: int, dh: int) -> Dict[str, float]:
    """The training backward (K2): reads qkv, out, the output's cotangent
    (bf16) and the f32 log-sum-exp, writes dqkv [B, N, 3 H dh] bf16; five
    products of 2 B H N^2 dh (the scores again, dP, dV, dQ, dK)."""
    nbytes = 2 * (b * n * 3 * h * dh + 2 * b * n * h * dh + b * n * 3 * h * dh) + 4 * b * h * n
    return {"ops": 2.5 * attention_ops(b, h, n, n, dh), "bytes": float(nbytes),
            "dtype": "bf16"}
