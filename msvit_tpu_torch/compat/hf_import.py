"""Import HF ViT / DINOv2 PyTorch checkpoints into state dicts of the port's
`ViTModel` (counterpart of `msvit_tpu/compat/hf_import.py`).

HF and the port are both PyTorch, so most tensors copy as they are:

* a ``Linear.weight`` ``[out, in]`` keeps its layout (no transpose);
* the q, k and v projections stack into the fused ``attention.qkv`` rows
  in (q | k | v, head, e) order, and so do their biases;
* the stride-P patch conv ``[D, C, P, P]`` becomes the ``patch_projection``
  Linear ``[D, P*P*C]`` with its features in (p1, p2, c) order, the order
  of `models/base/vit.py::patchify`.

Nothing is downloaded: callers pass a state dict (`torch.load`,
safetensors, or a live `transformers` model's `state_dict()`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from msvit_tpu_torch.models.base.config import BaseViTConfig


def _t(x: Any) -> torch.Tensor:
    """A detached f32 CPU copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a .bin / .pt / .safetensors checkpoint into CPU tensors."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"loading {path} needs the 'safetensors' package") from e
        return dict(load_file(path, device="cpu"))
    return dict(torch.load(path, map_location="cpu", weights_only=True))


# HF ViTModel vs Dinov2Model names of the same layer tensors
_LAYER_ALIASES = {
    "norm1": ("layernorm_before", "norm1"),
    "norm2": ("layernorm_after", "norm2"),
    "fc1": ("intermediate.dense", "mlp.fc1"),
    "fc2": ("output.dense", "mlp.fc2"),
}


def _get(sd: Mapping[str, Any], *names: str) -> torch.Tensor:
    for n in names:
        if n in sd:
            return _t(sd[n])
    raise KeyError(f"none of {names} found in state_dict")


def _has(sd: Mapping[str, Any], *names: str) -> bool:
    return any(n in sd for n in names)


def import_vit_params(
    state_dict: Mapping[str, Any],
    config: BaseViTConfig,
    add_cls_token: bool = True,
    add_pooler: bool = False,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """An HF ViTModel / Dinov2Model state dict -> state dict of the port's
    `ViTModel` (f32 CPU tensors).

    As the JAX function: a missing pooler or CLS token is tolerated (a
    partial load); ``add_cls_token=False`` also drops the CLS token's
    position row; a checkpoint without layer scale gets
    ``config.layerscale_value``."""
    d = config.hidden_size
    g = lambda *names: _get(state_dict, *(prefix + n for n in names))  # noqa: E731
    has = lambda *names: _has(state_dict, *(prefix + n for n in names))  # noqa: E731

    out: Dict[str, torch.Tensor] = {}
    conv_w = g("embeddings.patch_embeddings.projection.weight")  # [D, C, P, P]
    out["embeddings.patch_projection.weight"] = conv_w.permute(0, 2, 3, 1).reshape(d, -1) \
        .contiguous()
    out["embeddings.patch_projection.bias"] = g("embeddings.patch_embeddings.projection.bias")
    pos = g("embeddings.position_embeddings")
    if add_cls_token and has("embeddings.cls_token"):
        out["embeddings.cls_token"] = g("embeddings.cls_token")
    if not add_cls_token:
        pos = pos[:, 1:].contiguous()  # the CLS row goes with the token
    out["embeddings.position_embeddings"] = pos

    def alias(lp: str, name: str, leaf: str) -> torch.Tensor:
        return g(*(lp + a + leaf for a in _LAYER_ALIASES[name]))

    for i in range(config.num_hidden_layers):
        lp, key = f"encoder.layer.{i}.", f"encoder.layer.{i}."
        qkv = [g(lp + f"attention.attention.{n}.weight") for n in ("query", "key", "value")]
        out[key + "attention.qkv.weight"] = torch.cat(qkv, 0)
        if config.qkv_bias:
            out[key + "attention.qkv.bias"] = torch.cat(
                [g(lp + f"attention.attention.{n}.bias") for n in ("query", "key", "value")])
        out[key + "attention.output_dense.weight"] = g(lp + "attention.output.dense.weight")
        out[key + "attention.output_dense.bias"] = g(lp + "attention.output.dense.bias")
        for name in ("norm1", "norm2"):
            out[key + name + ".weight"] = alias(lp, name, ".weight")
            out[key + name + ".bias"] = alias(lp, name, ".bias")
        if config.use_swiglu_ffn:  # DINOv2's SwiGLU names are the port's
            for name in ("weights_in", "weights_out"):
                out[key + f"mlp.{name}.weight"] = g(lp + f"mlp.{name}.weight")
                out[key + f"mlp.{name}.bias"] = g(lp + f"mlp.{name}.bias")
        else:
            for name in ("fc1", "fc2"):
                out[key + f"mlp.{name}.weight"] = alias(lp, name, ".weight")
                out[key + f"mlp.{name}.bias"] = alias(lp, name, ".bias")
        if has(lp + "layer_scale1.lambda1"):
            out[key + "layer_scale1"] = g(lp + "layer_scale1.lambda1")
            out[key + "layer_scale2"] = g(lp + "layer_scale2.lambda1")
        else:
            for name in ("layer_scale1", "layer_scale2"):
                out[key + name] = torch.full((d,), float(np.float32(config.layerscale_value)))

    out["layernorm.weight"] = g("layernorm.weight")
    out["layernorm.bias"] = g("layernorm.bias")
    if add_pooler and has("pooler.dense.weight"):
        out["pooler_dense.weight"] = g("pooler.dense.weight")
        out["pooler_dense.bias"] = g("pooler.dense.bias")
    return out
