"""`from_pretrained`-style loading (counterpart of
`msvit_tpu/compat/pretrained.py`).

Local paths are resolved first; the HuggingFace hub is tried only when the
argument is not a path and its host name resolves.  Nothing is downloaded
implicitly from a config.

    cfg, state = load_pretrained_vit("/ckpts/dino-vitb8")        # local dir
    cfg, state = load_pretrained_vit("weights.safetensors", cfg)  # file
    model = ViTModel(cfg); model.load_state_dict(state)

A local directory is in HF layout: a ``config.json`` beside
``model.safetensors`` or ``pytorch_model.bin``, as ``save_pretrained`` and
``huggingface_hub.snapshot_download`` write it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from msvit_tpu_torch.compat.hf_import import import_vit_params, load_torch_state_dict
from msvit_tpu_torch.models.base.config import BaseViTConfig

_WEIGHT_NAMES = ("model.safetensors", "pytorch_model.bin")


def config_from_hf(hf: Dict[str, Any], **overrides) -> BaseViTConfig:
    """Map an HF ViT / Dinov2 ``config.json`` dict onto `BaseViTConfig`."""
    model_type = hf.get("model_type", "vit")
    kw: Dict[str, Any] = dict(
        hidden_size=hf.get("hidden_size", 768),
        num_hidden_layers=hf.get("num_hidden_layers", 12),
        num_attention_heads=hf.get("num_attention_heads", 12),
        image_size=hf.get("image_size", 224),
        patch_size=hf.get("patch_size", 16),
        num_channels=hf.get("num_channels", 3),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-6),
        qkv_bias=hf.get("qkv_bias", True),
    )
    if "intermediate_size" in hf:
        kw["mlp_ratio"] = hf["intermediate_size"] / kw["hidden_size"]
    elif "mlp_ratio" in hf:
        kw["mlp_ratio"] = hf["mlp_ratio"]
    if model_type == "dinov2":
        kw["use_swiglu_ffn"] = hf.get("use_swiglu_ffn", False)
        kw["layerscale_value"] = hf.get("layerscale_value", 1.0)
    kw.update(overrides)
    return BaseViTConfig(**kw)


def _network_available(host: str = "huggingface.co") -> bool:
    import socket

    try:
        socket.getaddrinfo(host, 443)
        return True
    except OSError:
        return False


def _read_config(directory: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(directory, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def resolve_checkpoint(path_or_id: str) -> Tuple[str, Optional[Dict[str, Any]]]:
    """path or hub id -> (weights file path, parsed config.json or None).

    A local file or directory wins; otherwise a hub download is tried only
    when the hub's host name resolves (no network: a clear error, no
    hang)."""
    if os.path.isfile(path_or_id):
        return path_or_id, _read_config(os.path.dirname(path_or_id))
    if os.path.isdir(path_or_id):
        for name in _WEIGHT_NAMES:
            p = os.path.join(path_or_id, name)
            if os.path.isfile(p):
                return p, _read_config(path_or_id)
        raise FileNotFoundError(
            f"{path_or_id}: no {'/'.join(_WEIGHT_NAMES)} in directory"
        )
    if not _network_available():
        raise FileNotFoundError(
            f"'{path_or_id}' is not a local path and the HuggingFace hub is "
            "unreachable (no network). Pre-fetch on a networked host with "
            "`huggingface_hub.snapshot_download` and pass the directory."
        )
    from huggingface_hub import hf_hub_download

    last_err: Optional[Exception] = None
    for name in _WEIGHT_NAMES:
        try:
            weights = hf_hub_download(path_or_id, name)
            break
        except Exception as e:  # try the next file name
            last_err = e
    else:
        raise FileNotFoundError(
            f"no {'/'.join(_WEIGHT_NAMES)} found for hub id '{path_or_id}'"
        ) from last_err
    cfg = None
    try:
        with open(hf_hub_download(path_or_id, "config.json")) as f:
            cfg = json.load(f)
    except Exception:
        pass
    return weights, cfg


def load_state_dict_from(path_or_id: str) -> Dict[str, torch.Tensor]:
    """Resolve a path, directory or hub id and load its state dict: the
    front door of the per-family importers (`compat/family_import.py`)."""
    weights_path, _ = resolve_checkpoint(path_or_id)
    return load_torch_state_dict(weights_path)


def load_pretrained_vit(
    path_or_id: str,
    config: Optional[BaseViTConfig] = None,
    add_cls_token: bool = True,
    add_pooler: bool = False,
    **config_overrides,
) -> Tuple[BaseViTConfig, Dict[str, torch.Tensor]]:
    """(config, state dict of the port's `ViTModel`) in one call.

    The config comes from the checkpoint's ``config.json`` unless it is
    given; ``config_overrides`` (e.g. ``policy=...``) apply on top."""
    weights_path, hf_cfg = resolve_checkpoint(path_or_id)
    if config is None:
        if hf_cfg is None:
            raise ValueError(
                f"{path_or_id} has no config.json — pass `config=` explicitly"
            )
        config = config_from_hf(hf_cfg, **config_overrides)
    elif config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    sd = load_torch_state_dict(weights_path)
    state = import_vit_params(sd, config, add_cls_token=add_cls_token,
                              add_pooler=add_pooler)
    return config, state
