"""int8 quantization primitives (counterpart of `msvit_tpu/ops/quant.py`).

The symmetric scheme of the JAX package:

* weights: static per-output-channel int8 (quantized once from f32);
* activations: per-tensor int8, from the runtime absmax or a calibrated
  static scale;
* the GEMM accumulates in int32 (`torch._int_mm`, the counterpart of XLA's
  int8 `dot_general`) and the epilogue dequantizes, or requantizes to int8,
  in plain torch with round-half-to-even as `jnp.round`.

Layout: a `QuantizedTensor` holds the weight the `nn.Linear` way,
``values [out, in]`` int8 with ``scale [out]`` f32, so the GEMM reads it
as a column-major ``[in, out]`` operand, the layout the card's int8 GEMM
takes directly.  (The JAX package keeps ``[in, out]``; the converter and
the tests transpose.)

`torch._int_mm` on the card needs more than 16 rows and both K and the
output width a multiple of 8; smaller row counts are padded here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class QuantizedTensor(NamedTuple):
    values: torch.Tensor  # int8 [out, in]
    scale: torch.Tensor  # f32 [out]


def quantize_weight(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel quantization of a Linear weight
    [out, in]."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def quantize_activation(
    x: torch.Tensor, scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization -> (int8, scalar scale).  With a
    calibrated `scale` the absmax reduction is skipped."""
    x32 = x.float()
    if scale is None:
        scale = torch.clamp(x32.abs().amax(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(
    x: torch.Tensor,
    w: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    act_scale: Optional[torch.Tensor] = None,
    out_inv_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8 GEMM with a dequant epilogue; the activation scale is dynamic
    (absmax) or calibrated (`act_scale`).  With `out_inv_scale`
    (broadcastable to the output's last dim) the epilogue requantizes and
    the output is int8."""
    xq, sx = quantize_activation(x, act_scale)
    return int8_matmul_prequant(xq, sx, w, bias, out_dtype, out_inv_scale)


def _int_mm(x2: torch.Tensor, w_values: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [out, K]^T int8 -> [M, out] int32."""
    m = x2.shape[0]
    if x2.is_cuda and m <= 16:
        pad = torch.zeros((17 - m, x2.shape[1]), dtype=x2.dtype,
                          device=x2.device)
        return torch._int_mm(torch.cat([x2, pad]), w_values.t())[:m]
    return torch._int_mm(x2, w_values.t())


def int8_matmul_prequant(
    xq: torch.Tensor,
    sx: torch.Tensor,
    w: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    out_inv_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8 GEMM whose input was quantized upstream (scale `sx`)."""
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]).contiguous(), w.values)
    out = acc.float() * (sx * w.scale)
    if bias is not None:
        out = out + bias.float()
    out = out.reshape(*lead, -1)
    if out_inv_scale is not None:
        return torch.clamp(
            torch.round(out * out_inv_scale), -127, 127
        ).to(torch.int8)
    return out.to(out_dtype)
