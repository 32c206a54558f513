"""Evaluation loop: top-k accuracy and loss (counterpart of
`msvit_tpu/eval.py`).

* Each step computes per-batch *sums* (correct@k counts, summed loss,
  example count) that stay on the device and accumulate there; the host
  reads them once, at the end.
* The last, short batch is padded up to the batch size and masked by
  `valid` (weights 0/1), so every step has one shape.
* top-k with one `torch.topk` over the logits.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LogitsFn = Callable[[Any, torch.Tensor], torch.Tensor]


def make_eval_step(logits_fn: LogitsFn, topk: Sequence[int] = (1, 5)):
    """Build a step: (model, pixel_values, labels, valid) -> {"n": sum of
    valid, "loss_sum": sum of ce * valid, "correct@k": sum of hit_k *
    valid}, device scalars.  `logits_fn(model, pixel_values)` -> [B, C];
    `valid` is a 0/1 float mask of real (non-padding) rows."""
    ks = tuple(int(k) for k in topk)
    kmax = max(ks)

    def step(model, pixel_values, labels, valid):
        logits = logits_fn(model, pixel_values).float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        top_idx = torch.topk(logits, kmax, dim=-1).indices  # sorted desc
        hits = top_idx == labels[:, None]
        out = {"n": valid.sum(), "loss_sum": (ce * valid).sum()}
        for k in ks:
            out[f"correct@{k}"] = (hits[:, :k].any(-1).float() * valid).sum()
        return out

    return step


def _device(model: Any) -> torch.device:
    if isinstance(model, nn.Module):
        for p in model.parameters():
            return p.device
    return torch.device("cpu")


def evaluate(
    logits_fn: LogitsFn,
    model: Any,
    batches: Iterable[Dict[str, Any]],
    topk: Sequence[int] = (1, 5),
    batch_size: Optional[int] = None,
) -> Dict[str, float]:
    """Run the eval loop over `batches` (dicts with "pixel_values" [B, ...]
    and "labels" [B]; optional "valid" [B] 0/1) on the model's device,
    under `torch.inference_mode()`.  Short batches are padded up to
    `batch_size` (default: the first batch's size).  Returns {"n", "loss",
    "top{k}_acc"...}, with one host sync in all."""
    step = make_eval_step(logits_fn, topk)
    dev = _device(model)
    totals: Optional[Dict[str, torch.Tensor]] = None
    with torch.inference_mode():
        for batch in batches:
            pix = torch.as_tensor(batch["pixel_values"]).to(dev)
            labels = torch.as_tensor(batch["labels"]).to(dev).long()
            b = pix.shape[0]
            if batch_size is None:
                batch_size = b
            valid = torch.as_tensor(
                batch.get("valid", torch.ones(b)), dtype=torch.float32).to(dev)
            if b < batch_size:
                pad = batch_size - b
                pix = torch.cat([pix, pix.new_zeros((pad, *pix.shape[1:]))])
                labels = torch.cat([labels, labels.new_zeros(pad)])
                valid = torch.cat([valid, valid.new_zeros(pad)])
            elif b > batch_size:
                raise ValueError(f"batch of {b} exceeds eval batch_size {batch_size}")
            part = step(model, pix, labels, valid)
            totals = part if totals is None else {
                k: totals[k] + v for k, v in part.items()}
    if totals is None:
        return {"n": 0.0}
    keys = list(totals)
    vals = torch.stack([totals[k] for k in keys]).tolist()  # one sync
    host = dict(zip(keys, vals))
    n = max(host["n"], 1.0)
    out = {"n": host["n"], "loss": host["loss_sum"] / n}
    for k, v in host.items():
        if k.startswith("correct@"):
            out[f"top{k.split('@')[1]}_acc"] = v / n
    return out
