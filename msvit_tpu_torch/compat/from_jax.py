"""Flax param tree -> state dict of the port's `ViTModel` (and of
`ViTForImageClassification`, `classifier_params_from_jax`, of
`MultiStateViTEncoderModel`, `multistate_params_from_jax`, of
`MultiStateViTForImageClassification`,
`multistate_classifier_params_from_jax`, of `PredictiveViTModel`,
`predictive_params_from_jax`, of `SubsampleViTModel` and its classifier,
`subsample_params_from_jax` and `subsample_classifier_params_from_jax`, and
of the saccadic family's three modules, `saccadic_params_from_jax`).

Takes the JAX package's `ViTModel` params as nested dicts of numpy arrays
(with or without the top-level "params" collection) and never imports JAX.

* flax `Dense` kernels ``[in, out]`` become `Linear.weight [out, in]`;
* ``qkv_kernel [D, 3, H, dh]`` is reshaped to ``[D, 3*H*dh]`` in
  (t, h, e) order, the packed q | k | v column order, then transposed;
  ``qkv_bias [3, H, dh]`` becomes ``[3*H*dh]``;
* flax `Conv` kernels ``[k, k, in, out]`` become ``[out, in, k, k]``;
  `ConvTranspose` kernels ``[k, k, in, out]`` become torch's
  `conv_transpose2d` layout ``[in, out, k, k]``, flipped in both spatial
  axes (lax does not flip the kernel, torch's transposed conv does);
* an MoE layer's ``mlp/router`` is a Dense like the others; its raw
  ``experts_in [E, D, F]``, ``experts_out [E, F, D]`` and their biases keep
  their layout (`models/base/moe.py`);
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
        if isinstance(mod, Mapping):  # Dense: fc1/fc2, weights_in/out, MoE router
            _dense(out, f"{key}.mlp.{name}", mod)
        else:  # MoE expert arrays keep their layout
            out[f"{key}.mlp.{name}"] = _t(mod)


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


def predictive_params_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX `PredictiveViTModel` params -> state dict for the port's
    `PredictiveViTModel`."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    pe = params["patch_embeddings"]
    for i in range(5):
        k = _t(pe[f"enc{i}"]["kernel"])  # [k, k, in, out]
        out[f"patch_embeddings.enc_convs.{i}.weight"] = k.permute(3, 2, 0, 1).contiguous()
        out[f"patch_embeddings.enc_convs.{i}.bias"] = _t(pe[f"enc{i}"]["bias"])
        k = _t(pe[f"dec{i}"]["kernel"])
        out[f"patch_embeddings.dec_convs.{i}.weight"] = (
            k.flip(0, 1).permute(2, 3, 0, 1).contiguous())
        out[f"patch_embeddings.dec_convs.{i}.bias"] = _t(pe[f"dec{i}"]["bias"])
    _dense(out, "patch_embeddings.enc_dense", pe["enc_dense"])
    _dense(out, "patch_embeddings.dec_dense", pe["dec_dense"])
    _dense(out, "position_encoder", params["position_encoder"])
    out["position_decoder_kernel"] = _t(params["position_decoder_kernel"])
    if "position_decoder_bias" in params:
        out["position_decoder_bias"] = _t(params["position_decoder_bias"])
    out["cls_token"] = _t(params["cls_token"])
    out["prd_token"] = _t(params["prd_token"])
    enc = params["encoder"]
    n_layers = len([k for k in enc if k.startswith("layer_")])
    if cfg is not None and n_layers != cfg.num_hidden_layers:
        raise ValueError(f"tree has {n_layers} layers, config {cfg.num_hidden_layers}")
    for i in range(n_layers):
        _layer(out, f"encoder.layer.{i}", enc[f"layer_{i}"])
    return out


def _layers(out: Dict[str, torch.Tensor], key: str, tree: Mapping, cfg) -> None:
    n_layers = len([k for k in tree if k.startswith("layer_")])
    if cfg is not None and n_layers != cfg.num_hidden_layers:
        raise ValueError(f"tree has {n_layers} layers, config {cfg.num_hidden_layers}")
    for i in range(n_layers):
        _layer(out, f"{key}.layer.{i}", tree[f"layer_{i}"])


def subsample_params_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX `SubsampleViTModel` params ({"cls_token", "embeddings",
    "encoder", "projection", "layernorm"}) -> state dict for the port's
    `SubsampleViTModel`."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {"cls_token": _t(params["cls_token"])}
    emb = params["embeddings"]
    _dense(out, "embeddings.patch_projection", emb["patch_projection"])
    out["embeddings.position_embeddings"] = _t(emb["position_embeddings"])
    _layers(out, "encoder", params["encoder"], cfg)
    _dense(out, "projection", params["projection"])
    _norm(out, "layernorm", params["layernorm"])
    return out


def subsample_classifier_params_from_jax(
    params: Mapping, cfg=None
) -> Dict[str, torch.Tensor]:
    """JAX `SubsampleViTForImageClassification` params ({"model": ...,
    "classifier": ...}) -> state dict for the port's
    `SubsampleViTForImageClassification`."""
    if "params" in params:
        params = params["params"]
    out = {f"model.{k}": v for k, v in subsample_params_from_jax(params["model"], cfg).items()}
    _dense(out, "classifier", params["classifier"])
    return out


def saccadic_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX saccadic variables, {"embeddings": ..., "pattern": ...,
    "predictor": ...} (each a module's `init` output, with or without its
    "params" collection; any subset) -> state dict of the port's
    `SaccadicViTModel`, keys under ``embeddings.``, ``pattern.`` and
    ``predictor.`` (a single module's state is the keys under its
    prefix)."""
    out: Dict[str, torch.Tensor] = {}

    def tree(name):
        t = variables[name]
        return t["params"] if "params" in t else t

    if "embeddings" in variables:
        emb = tree("embeddings")
        _dense(out, "embeddings.patch_embeddings.projection",
               emb["patch_embeddings"]["projection"])
        _dense(out, "embeddings.position_encoder", emb["position_encoder"])
        _dense(out, "embeddings.position_decoder", emb["position_decoder"])
    if "pattern" in variables:
        for k, v in tree("pattern").items():  # mean_<K>, std_<K>, log_covariance_shift
            out[f"pattern.{k}"] = _t(v)
    if "predictor" in variables:
        prd = tree("predictor")
        for k, v in prd.items():
            if k.startswith("cls_tokens_"):
                out[f"predictor.{k}"] = _t(v)
        enc = prd["encoder"]
        for i in range(len([k for k in enc if k.startswith("layer_")])):
            src, dst = enc[f"layer_{i}"], f"predictor.encoder.layer.{i}"
            for name, mod in src["attention"].items():  # query, key, value[, distance]
                _dense(out, f"{dst}.attention.{name}", mod)
            for name in ("output_dense", "intermediate", "output"):
                _dense(out, f"{dst}.{name}", src[name])
            _norm(out, f"{dst}.layernorm_after", src["layernorm_after"])
    return out


def act_scales_from_jax(
    scales: Mapping, device: Optional[torch.device] = None
) -> Dict[str, torch.Tensor]:
    """Calibrated activation scales (`calibrate_act_scales` of either
    package) as f32 tensors on `device`."""
    return {k: _t(v).to(device) for k, v in scales.items()}
