"""Wire a trained base trunk into an encoder family's state dict
(counterpart of `msvit_tpu/compat/family_import.py`).

Only `transfer_base_to_multistate` is ported; the three `import_into_*`
functions take HF state dicts (or the subsample model) and wait for
`compat/hf_import.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from msvit_tpu_torch.models.base.vit import interpolate_pos_embed


def transfer_base_to_multistate(
    base_state: Mapping[str, torch.Tensor],
    state: Mapping[str, torch.Tensor],
    num_layers: int,
) -> Dict[str, torch.Tensor]:
    """The multistate bootstrap: a `ViTModel` state dict trained in this
    framework (`ViTForImageClassification`'s keys under ``vit.``, stripped
    by the caller) into a copy of a `MultiStateViTEncoderModel`'s `state`.

    As the JAX function: the patch projection; the position table minus its
    CLS row, resampled bicubically to the target's square grid where the
    lengths differ (`interpolate_pos_embed`); every trunk layer's tensors
    (the two models must agree on `qk_norm`, or the layers' key sets differ
    and this raises); the TX and RX tokens both from the CLS token.  Whatever else `state` holds is
    kept.  Every tensor of the result is a copy."""
    out = {k: v.clone() for k, v in state.items()}

    def put(key: str, value: torch.Tensor) -> None:
        if key not in out:
            raise KeyError(f"transfer_base_to_multistate: no {key!r} in the "
                           "multistate state dict")
        if out[key].shape != value.shape:
            raise ValueError(f"transfer_base_to_multistate: {key} is "
                             f"{tuple(out[key].shape)}, the base trunk's "
                             f"{tuple(value.shape)}")
        out[key] = value.detach().to(out[key].dtype).clone()

    for k, v in base_state.items():
        if k.startswith("embeddings.patch_projection."):
            put(k, v)
    pos = base_state["embeddings.position_embeddings"][:, 1:]  # drop the CLS row
    want = out["embeddings.position_embeddings"].shape[1]
    if pos.shape[1] != want:
        g = int(round(want**0.5))
        pos = interpolate_pos_embed(pos, want, (g, g), has_cls=False)
    put("embeddings.position_embeddings", pos)

    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}.", f"backbone.layer.{i}."
        have = {k[len(dst):] for k in out if k.startswith(dst)}
        give = {k[len(src):] for k in base_state if k.startswith(src)}
        if have != give:
            raise ValueError(
                f"layer {i}: the trunks' tensors differ ({sorted(have ^ give)}); "
                "build both models with the same qk_norm")
        for name in give:
            put(dst + name, base_state[src + name])

    cls = base_state["embeddings.cls_token"][0, 0]
    put("backbone.transmitter_token", cls)
    put("backbone.receiver_token", cls)
    return out
