"""int8 multistate serving forward (counterpart of
`msvit_tpu/models/multistate/quantized.py`).

The loop of `MultiStateViTEncoderBackbone` with every trunk GEMM int8 x int8
-> int32 (`models/base/quantized.py`'s layer params and `ops/quant.py`),
LayerNorms f32 -> bf16, the residual stream bf16.  Clustering, the mask
and the TX/RX duplication are the bf16 model's (`recluster`).

Attention, `attn_mode="bf16"` (the default and the only mode ported): the
bf16 QKV GEMM output goes, on the card, to `multi_head_attention(...,
inference=True)`, which takes K4 (`fused_attention_inference`) at 512 kv
tokens and more (the bench shape: 816); with `use_kernels=False`, or on
the CPU, the plain path.  The last layer runs the plain path with
probabilities, as in JAX: the pooler needs its RX -> TX block.
`attn_mode="int8"` (K9) and `"banded"` (K10) raise.

Inference only: every entry point runs under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from msvit_tpu_torch.models.base.quantized import _layer_norm, quantize_layer_params
from msvit_tpu_torch.models.base.vit import check_grid, patchify
from msvit_tpu_torch.models.multistate.config import MultiStateViTConfig
from msvit_tpu_torch.models.multistate.model import (
    as_rng,
    build_multistate_attention_mask,
    initial_cluster_tokens,
    recluster,
    soft_mask,
)
from msvit_tpu_torch.ops.attention import multi_head_attention, xla_attention
from msvit_tpu_torch.ops.gelu import gelu_erf_tanh
from msvit_tpu_torch.ops.packed_attention import merge_heads, unpack_qkv
from msvit_tpu_torch.ops.quant import int8_matmul, quantize_weight

_NOT_PORTED = {
    "int8": "attn_mode='int8' needs K9 (ops/packed_attention.py "
            "`_packed_int8_grouped`), not ported yet (ROADMAP.md queue 2)",
    "banded": "attn_mode='banded' needs K10 (ops/banded_attention.py "
              "`_token_rows_banded`), not ported yet (ROADMAP.md queue 2)",
}


@torch.inference_mode()
def quantize_multistate_params(model: nn.Module) -> Dict[str, Any]:
    """Port `MultiStateViTEncoderModel` -> quantized inference dict on the
    parameters' device (per-channel int8 weights, layer scales folded into
    the proj / fc2 dequant scales, the rest f32)."""
    sd = model.state_dict()
    n_layers = sum(1 for k in sd if k.startswith("backbone.layer.")
                   and k.endswith(".norm1.weight"))
    return {
        "embeddings": {
            "patch_projection": {
                "w": quantize_weight(sd["embeddings.patch_projection.weight"]),
                "bias": sd["embeddings.patch_projection.bias"],
            },
            "position_embeddings": sd["embeddings.position_embeddings"],
        },
        "backbone": {
            "transmitter_token": sd["backbone.transmitter_token"],
            "receiver_token": sd["backbone.receiver_token"],
            "layers": {
                f"layer_{i}": quantize_layer_params(sd, f"backbone.layer.{i}.")
                for i in range(n_layers)
            },
        },
    }


@torch.inference_mode()
def quantized_multistate_apply(
    qparams: Dict[str, Any],
    config: MultiStateViTConfig,
    pixel_values: torch.Tensor,  # [B, H, W, C] NHWC
    rng,
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    _record_scales: Optional[Dict[str, torch.Tensor]] = None,
    use_kernels: Optional[bool] = None,
    interpolate_pos_encoding: bool = False,
    attn_mode: str = "bf16",
) -> Dict[str, Any]:
    """int8 multistate inference forward.  Returns last_hidden_state,
    last_cluster_tokens, cluster_tokens (TX), last_cluster_indices,
    num_clusters and receiver_to_transmitter_attentions.

    `rng`: an `Rng`, an int seed or None.  `use_kernels=None` means
    kernels iff the pixels are on the card."""
    if attn_mode in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[attn_mode])
    if attn_mode != "bf16":
        raise ValueError(f"attn_mode must be 'bf16', 'int8' or 'banded'; got {attn_mode}")
    if interpolate_pos_encoding:
        raise NotImplementedError(
            "position-embedding interpolation is not ported yet (ROADMAP.md "
            "queue 1, item 2)")
    cfg = config
    cfg.check_supported()
    check_grid(cfg, pixel_values)
    b = pixel_values.shape[0]
    d, h = cfg.hidden_size, cfg.num_attention_heads
    c = cfg.max_clusters
    eps = cfg.layer_norm_eps
    rng = as_rng(rng)

    def mm(site, x, wp):
        if _record_scales is not None:
            _record_scales[site] = x.float().abs().amax() / 127.0
        s = act_scales.get(site) if act_scales else None
        return int8_matmul(x, wp["w"], wp["bias"], act_scale=s)

    emb = qparams["embeddings"]
    x = mm("patch", patchify(pixel_values, cfg.patch_size), emb["patch_projection"])
    hidden = x + emb["position_embeddings"].to(x.dtype)
    n = hidden.shape[1]
    kernels = pixel_values.is_cuda if use_kernels is None else use_kernels

    bb = qparams["backbone"]
    cluster_tokens = initial_cluster_tokens(
        bb["transmitter_token"], bb["receiver_token"], b, c, hidden.dtype)
    cluster_indices = torch.zeros((b, n), dtype=torch.long, device=hidden.device)
    n_clusters = torch.ones((), dtype=torch.long, device=hidden.device)
    mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)

    rx_to_tx = None
    parents_bound = 1
    for i in range(cfg.num_hidden_layers):
        if i >= cfg.pregeneration_period and i % cfg.generation_period == 0:
            rng, step_key = rng.split(2)
            cluster_indices, cluster_tokens, n_clusters, parents_bound = recluster(
                cfg, hidden, cluster_indices, cluster_tokens, step_key, parents_bound)
            mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)

        concat = torch.cat([cluster_tokens.reshape(b, 2 * c, d), hidden], 1)
        additive = soft_mask(mask, cfg)
        lp = bb["layers"][f"layer_{i}"]

        y = _layer_norm(concat, lp["norm1"], eps)
        qkv = mm(f"qkv_{i}", y, lp["qkv"])  # [B, 2C+N, 3D] bf16
        if _record_scales is not None:
            ys = qkv.float().reshape(-1, 3, d).abs().amax(0)
            _record_scales[f"attn_{i}"] = ys.amax(-1) / 127.0
        q, k, v = unpack_qkv(qkv, h)
        if i == cfg.num_hidden_layers - 1:
            o, probs = xla_attention(q, k, v, mask=additive)
            rx_to_tx = probs[:, :, 1:2 * c:2, 0:2 * c:2]
        elif kernels:
            o, _ = multi_head_attention(q, k, v, mask=additive, implementation="auto",
                                        inference=True)
        else:
            o, _ = xla_attention(q, k, v, mask=additive)
        concat = concat + mm(f"proj_{i}", merge_heads(o), lp["proj"])  # ls1 folded

        y = _layer_norm(concat, lp["norm2"], eps)
        y = gelu_erf_tanh(mm(f"fc1_{i}", y, lp["fc1"]))
        concat = concat + mm(f"fc2_{i}", y, lp["fc2"])  # ls2 folded

        cluster_tokens = concat[:, :2 * c].reshape(b, c, 2, d)
        hidden = concat[:, 2 * c:]

    return {
        "last_hidden_state": hidden,
        "last_cluster_tokens": cluster_tokens,
        "cluster_tokens": cluster_tokens[:, :, 0, :],
        "last_cluster_indices": cluster_indices,
        "num_clusters": n_clusters,
        "receiver_to_transmitter_attentions": rx_to_tx,
    }


@torch.inference_mode()
def calibrate_multistate_act_scales(
    qparams: Dict[str, Any],
    config: MultiStateViTConfig,
    sample_pixels: torch.Tensor,
    rng,
    margin: float = 1.1,
    use_kernels: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """One dynamic-quant forward over a representative batch, recording the
    per-site activation absmax scales (x a safety margin)."""
    record: Dict[str, torch.Tensor] = {}
    quantized_multistate_apply(qparams, config, sample_pixels, rng,
                               _record_scales=record, use_kernels=use_kernels)
    return {k: v * margin for k, v in record.items()}
