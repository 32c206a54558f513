"""Wire a trained base trunk into an encoder family's state dict
(counterpart of `msvit_tpu/compat/family_import.py`).

`transfer_base_to_multistate` and `transfer_base_to_subsample`; the three
`import_into_*` functions, which take HF state dicts, are in
`compat/family_import.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from msvit_tpu_torch.models.base.vit import interpolate_pos_embed


def _putter(name: str, out: Dict[str, torch.Tensor], pre: str = ""):
    """``put(key, value)``: a copy of `value` into ``out[pre + key]``, cast
    to its dtype; a key `out` lacks or another shape raises, naming `name`."""
    def put(key: str, value: torch.Tensor) -> None:
        key = pre + key
        if key not in out:
            raise KeyError(f"{name}: no {key!r} in the target state dict")
        if out[key].shape != value.shape:
            raise ValueError(f"{name}: {key} is {tuple(out[key].shape)}, the "
                             f"source's {tuple(value.shape)}")
        out[key] = value.detach().to(out[key].dtype).clone()
    return put


def _resampled(pos: torch.Tensor, want: int, has_cls: bool) -> torch.Tensor:
    """A [1, N(+1), D] table resampled bicubically to `want` rows (its CLS
    row among them when `has_cls`) on the target's square grid."""
    if pos.shape[1] == want:
        return pos
    n = want - (1 if has_cls else 0)
    g = int(round(n**0.5))
    return interpolate_pos_embed(pos, n, (g, g), has_cls=has_cls)


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
    put = _putter("transfer_base_to_multistate", out)

    for k, v in base_state.items():
        if k.startswith("embeddings.patch_projection."):
            put(k, v)
    pos = base_state["embeddings.position_embeddings"][:, 1:]  # drop the CLS row
    want = out["embeddings.position_embeddings"].shape[1]
    put("embeddings.position_embeddings", _resampled(pos, want, has_cls=False))

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


def transfer_base_to_subsample(
    base_state: Mapping[str, torch.Tensor],
    state: Mapping[str, torch.Tensor],
    num_layers: int,
) -> Dict[str, torch.Tensor]:
    """The subsample bootstrap: a `ViTModel` state dict trained in this
    framework (`ViTForImageClassification`'s keys under ``vit.``, stripped
    by the caller) into a copy of a `SubsampleViTModel`'s `state`, or of a
    `SubsampleViTForImageClassification`'s (keys under ``model.``).

    As the JAX function: trunk layers 0 .. num_layers - 1 by index (a layer
    the base trunk lacks raises, naming it; deeper layers of the base are
    not taken); the patch projection (both are one dense [P*P*C -> D] over
    the same (p1, p2, c) order; another patch size raises); the position
    table with its CLS row, resampled bicubically to the target's square
    grid where the lengths differ (`interpolate_pos_embed`); the CLS token.
    Whatever else `state` holds is kept.  Every tensor of the result is a
    copy."""
    out = {k: v.clone() for k, v in state.items()}
    pre = "model." if any(k.startswith("model.") for k in out) else ""
    put = _putter("transfer_base_to_subsample", out, pre)

    missing = [i for i in range(num_layers)
               if not any(k.startswith(f"encoder.layer.{i}.") for k in base_state)]
    if missing:
        raise ValueError(f"base trunk has no layer(s) {missing}; need {num_layers} "
                         "layers for the subsample model")
    for i in range(num_layers):
        src = f"encoder.layer.{i}."
        for k, v in base_state.items():
            if k.startswith(src):
                put(k, v)

    src_w = base_state["embeddings.patch_projection.weight"]
    dst_w = out[pre + "embeddings.patch_projection.weight"]
    if src_w.shape != dst_w.shape:
        raise ValueError(
            f"patch_projection shapes differ ({tuple(src_w.shape)} vs "
            f"{tuple(dst_w.shape)}): the subsample config must use the base "
            "trunk's patch_size")
    for k, v in base_state.items():
        if k.startswith("embeddings.patch_projection."):
            put(k, v)
    want = out[pre + "embeddings.position_embeddings"].shape[1]
    put("embeddings.position_embeddings",
        _resampled(base_state["embeddings.position_embeddings"], want, has_cls=True))
    put("cls_token", base_state["embeddings.cls_token"])
    return out
