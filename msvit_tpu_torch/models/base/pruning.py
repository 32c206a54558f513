"""Attention-head pruning (counterpart of `msvit_tpu/models/base/pruning.py`,
HF `prune_heads` semantics: drop the selected heads' q/k/v projections and
the matching input columns of the attention output projection).

In the port's layout a head is one dh-row block in each third of
``attention.qkv.weight`` (and ``.bias``), rows in (q | k | v, head, e)
order, and one dh-column block of ``attention.output_dense.weight``.

* `prune_heads`: the surgery.  Every layer must end with the same head
  count (one ``num_attention_heads`` drives every layer), or it raises as
  JAX does; the returned config pins ``attention_head_size``.  The
  attention kernels then read ``[B, N, 3*H'*dh]`` with H'*dh < D.
* `prune_heads_masked`: zeroes the heads' q/k/v rows and output columns;
  every shape is kept and the output equals the surgery's.  Any per-layer
  head sets.  The flat layout does not show the head axis, so, unlike the
  JAX function, it takes the config.

Both take and return a state dict of any module whose trunk layers are
``<prefix>layer.<i>.attention.*`` (`ViTModel`'s ``encoder.``,
`ViTForImageClassification`'s ``vit.encoder.``, the multistate
``backbone.``); the input is not changed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from msvit_tpu_torch.models.base.config import BaseViTConfig

_QKV = re.compile(r"^(.*layer\.)0\.attention\.qkv\.weight$")


def _find_layers(state: Mapping[str, torch.Tensor]) -> str:
    """The key prefix of the trunk's ``layer.<i>.`` entries."""
    for k in state:
        m = _QKV.match(k)
        if m:
            return m.group(1)
    raise KeyError("no trunk layer (layer.0.attention.qkv.weight) in the state dict")


def _normalize(heads: Mapping[Any, Sequence[int]]) -> Dict[int, list]:
    return {int(i): sorted({int(x) for x in hs}) for i, hs in heads.items()}


def _head_rows(hs: Sequence[int], h: int, dh: int, device) -> torch.Tensor:
    """Rows of the qkv weight [3*H*dh, D] that belong to heads `hs`."""
    idx = torch.as_tensor(list(hs), dtype=torch.long, device=device)
    per_section = (idx[:, None] * dh + torch.arange(dh, device=device)).reshape(-1)
    return (torch.arange(3, device=device)[:, None] * (h * dh) + per_section).reshape(-1)


def prune_heads(
    params: Mapping[str, torch.Tensor],
    config: BaseViTConfig,
    heads: Mapping[Any, Sequence[int]],
) -> Tuple[Dict[str, torch.Tensor], BaseViTConfig]:
    """Remove heads (HF `prune_heads` surgery).  `heads` maps a layer index
    to head indices into the current head axis; every layer must be listed
    with the same number of heads.  Returns a new (state dict, config);
    pruning nothing returns the inputs themselves."""
    per_layer = {i: hs for i, hs in _normalize(heads).items() if hs}
    if not per_layer:
        return params, config

    h, dh = config.num_attention_heads, config.head_dim
    counts = {len(hs) for hs in per_layer.values()}
    if len(counts) != 1 or set(per_layer) != set(range(config.num_hidden_layers)):
        raise ValueError(
            "prune_heads (surgery mode) needs the SAME number of pruned "
            "heads in EVERY layer (one num_attention_heads for every layer). "
            "For non-uniform head sets use prune_heads_masked, which is "
            "numerically identical and keeps all shapes."
        )
    k = counts.pop()
    for i, hs in per_layer.items():
        if hs[0] < 0 or hs[-1] >= h:
            raise ValueError(f"layer {i}: head index out of range 0..{h - 1}")

    out = dict(params)
    pre = _find_layers(params)
    for i, hs in per_layer.items():
        lp = f"{pre}{i}.attention."
        w = out[lp + "qkv.weight"]
        keep = [j for j in range(h) if j not in hs]
        rows = _head_rows(keep, h, dh, w.device)
        out[lp + "qkv.weight"] = w.index_select(0, rows)
        if lp + "qkv.bias" in out:
            out[lp + "qkv.bias"] = out[lp + "qkv.bias"].index_select(0, rows)
        od = out[lp + "output_dense.weight"]
        out[lp + "output_dense.weight"] = od.index_select(1, rows[: len(keep) * dh])
    return out, dataclasses.replace(config, num_attention_heads=h - k,
                                    attention_head_size=dh)


def prune_heads_masked(
    params: Mapping[str, torch.Tensor],
    heads: Mapping[Any, Sequence[int]],
    config: BaseViTConfig,
) -> Dict[str, torch.Tensor]:
    """Zero the heads' q/k/v rows and output-projection columns: the
    surgery's output with every shape kept.  Any per-layer head sets.
    Returns a new state dict."""
    h, dh = config.num_attention_heads, config.head_dim
    out = dict(params)
    pre = _find_layers(params)
    for i, hs in _normalize(heads).items():
        if not hs:
            continue
        lp = f"{pre}{i}.attention."
        w = out[lp + "qkv.weight"]
        rows = _head_rows(hs, h, dh, w.device)
        out[lp + "qkv.weight"] = w.index_fill(0, rows, 0.0)
        if lp + "qkv.bias" in out:
            out[lp + "qkv.bias"] = out[lp + "qkv.bias"].index_fill(0, rows, 0.0)
        od = out[lp + "output_dense.weight"]
        out[lp + "output_dense.weight"] = od.index_fill(1, rows[: len(hs) * dh], 0.0)
    return out
