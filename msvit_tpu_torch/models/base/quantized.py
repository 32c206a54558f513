"""int8-quantized ViT inference path (counterpart of
`msvit_tpu/models/base/quantized.py`).

Every matmul of the trunk (patchify, fused QKV, output projection, fc1,
fc2) runs int8 x int8 -> int32; LayerNorm statistics, softmax and the
residual stream stay f32/bf16 exactly where the JAX package keeps them
(LayerNorm outputs and the residual stream are bf16).  Weights are
quantized once per output channel (`quantize_vit_params`), activations per
tensor, dynamically or from calibrated scales (`calibrate_act_scales`).

With calibrated scales and kernels on, attention is fully int8: the QKV
GEMM requantizes its output per section (q | k | v), K3
(`packed_attention_int8`) runs both attention products in int8 and emits
int8 at the output projection's input scale.  Without calibrated
per-section scales (and while calibrating), attention runs K1
(`packed_attention`) on the bf16 QKV output with the default 1/sqrt(dh)
scale.

Inference only: both entry points run under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.norm import layer_norm
from msvit_tpu_torch.models.base.vit import grid_position_table, patchify
from msvit_tpu_torch.ops.attention import multi_head_attention
from msvit_tpu_torch.ops.gelu import gelu_erf_tanh
from msvit_tpu_torch.ops.packed_attention import (
    merge_heads,
    packed_attention,
    packed_attention_int8,
    unpack_qkv,
)
from msvit_tpu_torch.ops.quant import (
    QuantizedTensor,
    int8_matmul,
    int8_matmul_prequant,
    quantize_weight,
)


def _fold_ls(w: QuantizedTensor, bias: torch.Tensor, ls: torch.Tensor):
    # layer scale is a per-channel multiply on the branch output, the shape
    # of the dequant scale: (acc*s + b) * ls == acc*(s*ls) + b*ls
    ls = ls.float()
    return {"w": QuantizedTensor(w.values, w.scale * ls),
            "bias": bias.float() * ls}


def _norm(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def quantize_layer_params(sd: Mapping[str, torch.Tensor], prefix: str):
    """One BaseViTLayer (state-dict keys under `prefix`) -> quantized
    inference dict: qkv / proj / fc1 / fc2 int8 per channel, layer scales
    folded into the proj / fc2 dequant scales, norms passed through."""
    if prefix + "mlp.router.weight" in sd:
        # JAX fails here with a KeyError on mlp/fc1; the int8 apply has no
        # expert dispatch
        raise ValueError("quantize_layer_params: an MoE trunk (num_experts > 0) "
                         "has no int8 apply path; serve it through the bf16 path")
    if prefix + "mlp.fc1.weight" not in sd:
        raise ValueError("quantize_layer_params: the int8 path needs the GELU "
                         "MLP (fc1/fc2), not SwiGLU")
    if prefix + "attention.q_norm.weight" in sd:
        # the int8 apply loops run no q/k norm: serving a qk_norm trunk
        # through them would compute another attention
        raise ValueError("quantize_layer_params: a qk_norm trunk (q_norm / "
                         "k_norm weights) has no int8 apply path")
    g = lambda k: sd[prefix + k]  # noqa: E731
    return {
        "qkv": {"w": quantize_weight(g("attention.qkv.weight")),
                "bias": sd.get(prefix + "attention.qkv.bias")},
        "proj": _fold_ls(quantize_weight(g("attention.output_dense.weight")),
                         g("attention.output_dense.bias"), g("layer_scale1")),
        "fc1": {"w": quantize_weight(g("mlp.fc1.weight")),
                "bias": g("mlp.fc1.bias")},
        "fc2": _fold_ls(quantize_weight(g("mlp.fc2.weight")),
                        g("mlp.fc2.bias"), g("layer_scale2")),
        "norm1": _norm(sd, prefix + "norm1"),
        "norm2": _norm(sd, prefix + "norm2"),
    }


@torch.inference_mode()
def quantize_vit_params(model: nn.Module) -> Dict[str, Any]:
    """Port `ViTModel` -> quantized inference dict, on the parameters'
    device (kernels int8 + per-channel scales; everything else f32
    passthrough)."""
    sd = model.state_dict()
    n_layers = sum(1 for k in sd if k.startswith("encoder.layer.")
                   and k.endswith(".norm1.weight"))
    return {
        "embeddings": {
            "patch_projection": {
                "w": quantize_weight(sd["embeddings.patch_projection.weight"]),
                "bias": sd["embeddings.patch_projection.bias"],
            },
            "position_embeddings": sd["embeddings.position_embeddings"],
            "cls_token": sd["embeddings.cls_token"],
        },
        "encoder": {
            f"layer_{i}": quantize_layer_params(sd, f"encoder.layer.{i}.")
            for i in range(n_layers)
        },
        "layernorm": _norm(sd, "layernorm"),
    }


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float):
    return layer_norm(x, p["scale"], p["bias"], eps, torch.bfloat16)


@torch.inference_mode()
def quantized_vit_apply(
    qparams: Dict[str, Any],
    config: BaseViTConfig,
    pixel_values: torch.Tensor,  # [B, H, W, C] NHWC
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    _record_scales: Optional[Dict[str, torch.Tensor]] = None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """int8 inference forward; returns last_hidden_state [B, N+1, D] bf16.

    `act_scales` (from `calibrate_act_scales`) switches activation
    quantization from dynamic absmax to static calibrated scales.
    `use_kernels=None` means kernels iff the tensors are on the card;
    True on the CPU runs the kernels' plain versions along the same
    int8 data path (the counterpart of JAX's interpret mode)."""
    cfg = config
    b = pixel_values.shape[0]
    d, h = cfg.hidden_size, cfg.num_attention_heads
    hd = h * cfg.head_dim  # one q, k or v section: D, or less after prune_heads
    eps = cfg.layer_norm_eps

    def mm(site, x, wp):
        if _record_scales is not None:
            _record_scales[site] = x.float().abs().amax() / 127.0
        s = act_scales.get(site) if act_scales else None
        return int8_matmul(x, wp["w"], wp["bias"], act_scale=s)

    emb = qparams["embeddings"]
    x = mm("patch", patchify(pixel_values, cfg.patch_size),
           emb["patch_projection"])
    cls = emb["cls_token"].expand(b, 1, d)
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    pos = grid_position_table(emb["position_embeddings"], cfg, pixel_values, True)
    x = x + pos.to(x.dtype)

    kernels = pixel_values.is_cuda if use_kernels is None else use_kernels
    # the fully-int8 attention data path needs calibrated per-section scales
    int8_attn = (
        kernels
        and act_scales is not None
        and "attn_0" in act_scales
        and _record_scales is None
    )
    for i in range(cfg.num_hidden_layers):
        lp = qparams["encoder"][f"layer_{i}"]
        y = _layer_norm(x, lp["norm1"], eps)
        if int8_attn:
            sec = act_scales[f"attn_{i}"]  # [3]
            s_proj = act_scales[f"proj_{i}"]
            inv_cols = (1.0 / sec).repeat_interleave(hd)  # [3 H dh]
            qkv_q = int8_matmul(
                y, lp["qkv"]["w"], lp["qkv"]["bias"],
                act_scale=act_scales.get(f"qkv_{i}"), out_inv_scale=inv_cols,
            )
            out_q = packed_attention_int8(
                qkv_q, sec, h, out_inv_scale=1.0 / s_proj, int8_out=True
            )
            out = int8_matmul_prequant(
                out_q, s_proj, lp["proj"]["w"], lp["proj"]["bias"]
            )
        else:
            qkv = mm(f"qkv_{i}", y, lp["qkv"])  # [B, N, 3 H dh] bf16
            if _record_scales is not None:
                ys = qkv.float().reshape(-1, 3, hd).abs().amax(0)
                _record_scales[f"attn_{i}"] = ys.amax(-1) / 127.0
            if kernels:
                out = packed_attention(qkv, h)
            else:
                q, k, v = unpack_qkv(qkv, h)
                o, _ = multi_head_attention(q, k, v, implementation="xla")
                out = merge_heads(o)
            out = mm(f"proj_{i}", out, lp["proj"])  # layer_scale1 folded in
        x = x + out
        y = _layer_norm(x, lp["norm2"], eps)
        y = gelu_erf_tanh(mm(f"fc1_{i}", y, lp["fc1"]))
        x = x + mm(f"fc2_{i}", y, lp["fc2"])  # layer_scale2 folded in

    return _layer_norm(x, qparams["layernorm"], eps)


@torch.inference_mode()
def calibrate_act_scales(
    qparams: Dict[str, Any],
    config: BaseViTConfig,
    sample_pixels: torch.Tensor,
    margin: float = 1.1,
    use_kernels: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """One dynamic-quant forward over a representative batch, recording the
    per-site activation absmax scales (x a safety margin)."""
    record: Dict[str, torch.Tensor] = {}
    quantized_vit_apply(qparams, config, sample_pixels,
                        _record_scales=record, use_kernels=use_kernels)
    return {k: v * margin for k, v in record.items()}
