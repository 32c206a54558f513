"""Wire imported HF trunk weights into each encoder family's state dict
(counterpart of the `import_into_*` functions of
`msvit_tpu/compat/family_import.py`):

* multistate: the embeddings (patch projection, position table without
  its CLS row) and every trunk layer; TX and RX from the CLS token;
* predictive: the trunk layers and the CLS token only (its embeddings are
  its own glimpse tokenizer);
* subsample: a partial load of the trunk layers, the patch projection, the
  position table with its CLS row and the CLS token.

Each takes an HF state dict (`load_state_dict_from`), the family's config
and the family model's own `state_dict()`, and returns a new state dict
that `load_state_dict` takes: what the checkpoint does not give is kept,
and every tensor of the result is a copy.  A position table of another
grid is resampled bicubically to the target's (`interpolate_pos_embed`,
as `transfer_base_to_*` do).  The flax->flax transfers are in
`compat/family.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from msvit_tpu_torch.compat.family import _putter, _resampled
from msvit_tpu_torch.compat.hf_import import _t, import_vit_params


def _cls_token(state_dict: Mapping[str, Any]) -> torch.Tensor:
    return _t(state_dict["embeddings.cls_token"])[0, 0]


def import_into_multistate(state_dict: Mapping[str, Any], config,
                           state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state`: a `MultiStateViTEncoderModel`'s state dict.  TX and RX get
    two distinct copies of the CLS token."""
    trunk = import_vit_params(state_dict, config, add_cls_token=False)
    out = {k: v.clone() for k, v in state.items()}
    put = _putter("import_into_multistate", out)
    for k, v in trunk.items():
        if k.startswith("embeddings.patch_projection."):
            put(k, v)
    want = out["embeddings.position_embeddings"].shape[1]
    put("embeddings.position_embeddings",
        _resampled(trunk["embeddings.position_embeddings"], want, has_cls=False))
    for i in range(config.num_hidden_layers):
        src = f"encoder.layer.{i}."
        for k, v in trunk.items():
            if k.startswith(src):
                put(f"backbone.layer.{i}." + k[len(src):], v)
    cls = _cls_token(state_dict)
    put("backbone.transmitter_token", cls)
    put("backbone.receiver_token", cls)
    return out


def import_into_predictive(state_dict: Mapping[str, Any], config,
                           state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state`: a `PredictiveViTModel`'s state dict (``cls_token [D]``)."""
    trunk = import_vit_params(state_dict, config, add_cls_token=True)
    out = {k: v.clone() for k, v in state.items()}
    put = _putter("import_into_predictive", out)
    for k, v in trunk.items():
        if k.startswith("encoder."):
            put(k, v)
    put("cls_token", _cls_token(state_dict))
    return out


def import_into_subsample(state_dict: Mapping[str, Any], config,
                          state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state`: a `SubsampleViTModel`'s state dict, or a
    `SubsampleViTForImageClassification`'s (keys under ``model.``)."""
    trunk = import_vit_params(state_dict, config, add_cls_token=True)
    out = {k: v.clone() for k, v in state.items()}
    pre = "model." if any(k.startswith("model.") for k in out) else ""
    put = _putter("import_into_subsample", out, pre)
    for k, v in trunk.items():
        if k.startswith(("encoder.", "embeddings.patch_projection.")):
            put(k, v)
    want = out[pre + "embeddings.position_embeddings"].shape[1]
    put("embeddings.position_embeddings",
        _resampled(trunk["embeddings.position_embeddings"], want, has_cls=True))
    put("cls_token", _cls_token(state_dict)[None, None])
    return out
