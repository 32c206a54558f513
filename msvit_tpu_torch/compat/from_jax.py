"""Flax param tree -> state dict of the port's `ViTModel` (and of
`ViTForImageClassification`, `classifier_params_from_jax`, of
`MultiStateViTEncoderModel`, `multistate_params_from_jax`, and of
`MultiStateViTForImageClassification`,
`multistate_classifier_params_from_jax`).

Takes the JAX package's `ViTModel` params as nested dicts of numpy arrays
(with or without the top-level "params" collection) and never imports JAX.

* flax `Dense` kernels ``[in, out]`` become `Linear.weight [out, in]`;
* ``qkv_kernel [D, 3, H, dh]`` is reshaped to ``[D, 3*H*dh]`` in
  (t, h, e) order, the packed q | k | v column order, then transposed;
  ``qkv_bias [3, H, dh]`` becomes ``[3*H*dh]``;
* LayerNorm ``scale`` / ``bias`` become ``weight`` / ``bias``; the qk-norm
  ``q_norm/scale`` and ``k_norm/scale`` of a layer (``config.qk_norm``)
  become ``attention.q_norm.weight`` and ``attention.k_norm.weight``.

Scanned trunks (``encoder/layers``) are not taken: unstack them first
with `msvit_tpu.models.base.scan.unstack_layer_params`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(out: Dict[str, torch.Tensor], key: str, p: Mapping) -> None:
    out[key + ".weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[key + ".bias"] = _t(p["bias"])


def _norm(out: Dict[str, torch.Tensor], key: str, p: Mapping) -> None:
    out[key + ".weight"] = _t(p["scale"])
    out[key + ".bias"] = _t(p["bias"])


def _layer(out: Dict[str, torch.Tensor], key: str, p: Mapping) -> None:
    attn = p["attention"]
    for name in ("q_norm", "k_norm"):  # config.qk_norm: a scale, no bias
        if name in attn:
            out[f"{key}.attention.{name}.weight"] = _t(attn[name]["scale"])
    w = np.asarray(attn["qkv_kernel"], np.float32)  # [D, 3, H, dh]
    out[key + ".attention.qkv.weight"] = _t(w.reshape(w.shape[0], -1)).T.contiguous()
    if "qkv_bias" in attn:
        out[key + ".attention.qkv.bias"] = _t(np.asarray(attn["qkv_bias"]).reshape(-1))
    _dense(out, key + ".attention.output_dense", attn["output_dense"])
    _norm(out, key + ".norm1", p["norm1"])
    _norm(out, key + ".norm2", p["norm2"])
    out[key + ".layer_scale1"] = _t(p["layer_scale1"])
    out[key + ".layer_scale2"] = _t(p["layer_scale2"])
    for name, mod in p["mlp"].items():
        _dense(out, f"{key}.mlp.{name}", mod)


def vit_params_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX `ViTModel` params -> state dict for the port's `ViTModel`
    (f32 CPU tensors; `load_state_dict` casts and moves them).  `cfg`, when
    given, is checked against the tree's depth."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    _dense(out, "embeddings.patch_projection", emb["patch_projection"])
    out["embeddings.position_embeddings"] = _t(emb["position_embeddings"])
    if "cls_token" in emb:
        out["embeddings.cls_token"] = _t(emb["cls_token"])
    enc = params["encoder"]
    if "layers" in enc:
        raise ValueError("scanned trunk: unstack_layer_params first")
    n_layers = len([k for k in enc if k.startswith("layer_")])
    if cfg is not None and n_layers != cfg.num_hidden_layers:
        raise ValueError(
            f"tree has {n_layers} layers, config {cfg.num_hidden_layers}"
        )
    for i in range(n_layers):
        _layer(out, f"encoder.layer.{i}", enc[f"layer_{i}"])
    _norm(out, "layernorm", params["layernorm"])
    if "pooler_dense" in params:
        _dense(out, "pooler_dense", params["pooler_dense"])
    return out


def classifier_params_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX `ViTForImageClassification` params ({"vit": ..., "classifier":
    ...}) -> state dict for the port's `ViTForImageClassification`."""
    if "params" in params:
        params = params["params"]
    out = {f"vit.{k}": v for k, v in vit_params_from_jax(params["vit"], cfg).items()}
    _dense(out, "classifier", params["classifier"])
    return out


def multistate_params_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX `MultiStateViTEncoderModel` params ({"embeddings": ...,
    "backbone": {"transmitter_token", "receiver_token", "layer_i"}}) ->
    state dict for the port's `MultiStateViTEncoderModel`."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    _dense(out, "embeddings.patch_projection", emb["patch_projection"])
    out["embeddings.position_embeddings"] = _t(emb["position_embeddings"])
    bb = params["backbone"]
    out["backbone.transmitter_token"] = _t(bb["transmitter_token"])
    out["backbone.receiver_token"] = _t(bb["receiver_token"])
    n_layers = len([k for k in bb if k.startswith("layer_")])
    if cfg is not None and n_layers != cfg.num_hidden_layers:
        raise ValueError(f"tree has {n_layers} layers, config {cfg.num_hidden_layers}")
    for i in range(n_layers):
        _layer(out, f"backbone.layer.{i}", bb[f"layer_{i}"])
    return out


def multistate_classifier_params_from_jax(
    params: Mapping, cfg=None
) -> Dict[str, torch.Tensor]:
    """JAX `MultiStateViTForImageClassification` params ({"encoder": ...,
    "classifier": ...}) -> state dict for the port's
    `MultiStateViTForImageClassification`."""
    if "params" in params:
        params = params["params"]
    out = {f"encoder.{k}": v
           for k, v in multistate_params_from_jax(params["encoder"], cfg).items()}
    _dense(out, "classifier", params["classifier"])
    return out


def act_scales_from_jax(
    scales: Mapping, device: Optional[torch.device] = None
) -> Dict[str, torch.Tensor]:
    """Calibrated activation scales (`calibrate_act_scales` of either
    package) as f32 tensors on `device`."""
    return {k: _t(v).to(device) for k, v in scales.items()}
