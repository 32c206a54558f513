"""int8 multistate serving forward (counterpart of
`msvit_tpu/models/multistate/quantized.py`).

The loop of `MultiStateViTEncoderBackbone` with every trunk GEMM int8 x int8
-> int32 (`models/base/quantized.py`'s layer params and `ops/quant.py`),
LayerNorms f32 -> bf16, the residual stream bf16.  Clustering, the mask
and the TX/RX duplication are the bf16 model's (`recluster`).

Attention, by `attn_mode`:

* "bf16" (the default): the bf16 QKV GEMM output goes, with kernels, to
  `multi_head_attention(..., inference=True)`, whose "auto" takes K4
  (`fused_attention_inference`) where one head's score tile fits JAX's
  fused budget (the 224-px bench shape: 816 tokens) and K7
  (`flash_attention`; JAX's flash route has no shaved variant) beyond it
  (448 px: 3168 tokens); without kernels (`use_kernels=False`, or by
  default on the CPU) the plain path.
* "int8": with kernels and calibrated scales, the QKV GEMM requantizes its
  output per section (q | k | v at the calibrated `attn_i` scales), K9
  (`packed_attention_int8_masked`) runs both attention products in int8
  and emits int8 at the `proj_i` scale, and `int8_matmul_prequant` does
  the projection.  JAX's VMEM gate `int8_grouped_vmem_ok` is not ported:
  the port honours the mode at any N.  Otherwise as "bf16".
* "banded": the tokens are kept sorted by cluster id (as the bf16 model's
  banded mode), the q third of the QKV output is multiplied by dh^-0.5 in
  bf16, and `multistate_banded_attention` (K10 for the token rows) runs.

The last layer runs the plain path with probabilities, as in JAX: the
pooler needs its RX -> TX block.  Calibration (`_record_scales`) always
runs dense attention (absmax scales do not depend on the token order).

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
    SortedTokens,
    as_rng,
    build_multistate_attention_mask,
    initial_cluster_tokens,
    recluster,
    soft_mask,
)
from msvit_tpu_torch.ops.attention import multi_head_attention, xla_attention
from msvit_tpu_torch.ops.banded_attention import (
    BandedSegments, multistate_banded_attention)
from msvit_tpu_torch.ops.gelu import gelu_erf_tanh
from msvit_tpu_torch.ops.packed_attention import (
    merge_heads, packed_attention_int8_masked, unpack_qkv)
from msvit_tpu_torch.ops.quant import int8_matmul, int8_matmul_prequant, quantize_weight


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
    if attn_mode not in ("bf16", "int8", "banded"):
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
    int8_attn = (attn_mode == "int8" and kernels and act_scales is not None
                 and "attn_0" in act_scales and _record_scales is None)
    banded = attn_mode == "banded" and _record_scales is None
    sort = SortedTokens(banded, b, n, hidden.device)

    bb = qparams["backbone"]
    cluster_tokens = initial_cluster_tokens(
        bb["transmitter_token"], bb["receiver_token"], b, c, hidden.dtype)
    cluster_indices = torch.zeros((b, n), dtype=torch.long, device=hidden.device)
    n_clusters = torch.ones((), dtype=torch.long, device=hidden.device)
    mask = None if banded else build_multistate_attention_mask(cluster_indices, n_clusters, c)

    rx_to_tx = None
    parents_bound = 1
    for i in range(cfg.num_hidden_layers):
        if i >= cfg.pregeneration_period and i % cfg.generation_period == 0:
            rng, step_key = rng.split(2)
            h_orig = sort.unsort(hidden)
            child, cluster_tokens, n_clusters, parents_bound = recluster(
                cfg, h_orig, sort.unsort(cluster_indices), cluster_tokens, step_key,
                parents_bound)
            if banded:
                hidden, cluster_indices = sort.resort(child, h_orig)
            else:
                cluster_indices = child
                mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)

        concat = torch.cat([cluster_tokens.reshape(b, 2 * c, d), hidden], 1)
        last = i == cfg.num_hidden_layers - 1
        if banded and last:  # the last layer: dense, the mask over sorted tokens
            mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)
        additive = None if mask is None else soft_mask(mask, cfg)
        lp = bb["layers"][f"layer_{i}"]

        y = _layer_norm(concat, lp["norm1"], eps)
        if int8_attn and not last:
            sec = act_scales[f"attn_{i}"]  # [3]: q | k | v
            s_proj = act_scales[f"proj_{i}"]
            qkv_q = int8_matmul(y, lp["qkv"]["w"], lp["qkv"]["bias"],
                                act_scale=act_scales.get(f"qkv_{i}"),
                                out_inv_scale=(1.0 / sec).repeat_interleave(d))
            out_q = packed_attention_int8_masked(qkv_q, sec, h, mask=additive,
                                                 out_inv_scale=1.0 / s_proj, int8_out=True)
            out = int8_matmul_prequant(out_q, s_proj, lp["proj"]["w"], lp["proj"]["bias"])
        else:
            qkv = mm(f"qkv_{i}", y, lp["qkv"])  # [B, 2C+N, 3D] bf16
            if _record_scales is not None:
                ys = qkv.float().reshape(-1, 3, d).abs().amax(0)
                _record_scales[f"attn_{i}"] = ys.amax(-1) / 127.0
            if banded and not last:
                dh = d // h
                qkv_s = torch.cat([qkv[:, :, :d] * torch.tensor(dh**-0.5, dtype=qkv.dtype),
                                   qkv[:, :, d:]], -1)
                o = multistate_banded_attention(qkv_s, BandedSegments(
                    cluster_indices, n_clusters, c, cfg.attention_mask_inf), h)
            else:
                q, k, v = unpack_qkv(qkv, h)
                if last:
                    o, probs = xla_attention(q, k, v, mask=additive)
                    rx_to_tx = probs[:, :, 1:2 * c:2, 0:2 * c:2]
                elif kernels:
                    o, _ = multi_head_attention(q, k, v, mask=additive,
                                                implementation="auto", inference=True)
                else:
                    o, _ = xla_attention(q, k, v, mask=additive)
                o = merge_heads(o)
            out = mm(f"proj_{i}", o, lp["proj"])  # ls1 folded
        concat = concat + out

        y = _layer_norm(concat, lp["norm2"], eps)
        y = gelu_erf_tanh(mm(f"fc1_{i}", y, lp["fc1"]))
        concat = concat + mm(f"fc2_{i}", y, lp["fc2"])  # ls2 folded

        cluster_tokens = concat[:, :2 * c].reshape(b, c, 2, d)
        hidden = concat[:, 2 * c:]

    return {
        "last_hidden_state": sort.unsort(hidden),
        "last_cluster_tokens": cluster_tokens,
        "cluster_tokens": cluster_tokens[:, :, 0, :],
        "last_cluster_indices": sort.unsort(cluster_indices),
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
