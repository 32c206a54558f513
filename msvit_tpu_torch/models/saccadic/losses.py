"""Saccadic losses (counterpart of `msvit_tpu/models/saccadic/losses.py`):
the three objectives of the family's design notes (predictive, positional
recovery, preservation).

* differentiable batch objectives, for training the pattern bank and the
  refiner on pools of glimpse embeddings:
  - `pattern_nll_loss`: minus the best fully bound (zero-wildcard) match's
    joint log-pdf, averaged over the batch and the complexities;
  - `refiner_preservation_loss`: refined node embeddings should preserve
    the inputs (squared error), with the matches' best joint log-pdf as
    aux;
* `trace_losses`: host-side diagnostics over a serial controller trace
  (predicted vs realised embedding; decoded vs issued query; refined vs
  raw embedding).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from msvit_tpu_torch.models.saccadic.embeddings import SaccadicViTEmbeddings
from msvit_tpu_torch.models.saccadic.pattern import SaccadicViTMultiStatePattern
from msvit_tpu_torch.models.saccadic.refiner import TransformerSaccadicViTPredictor


def pattern_nll_loss(
    pattern: SaccadicViTMultiStatePattern,
    hidden_states: torch.Tensor,  # [B, N, D]
    context_states: torch.Tensor,  # [B, C, D]
) -> torch.Tensor:
    """-E[max joint log-pdf] over the fully bound matches of every
    complexity, differentiable through the beam's pdf terms (the discrete
    top-k indices act as a hard assignment)."""
    matches = pattern.match(hidden_states, context_states, 0)
    nll, count = 0.0, 0
    for (_k, n_wild), p in matches.items():
        if n_wild != 0:
            continue
        nll = nll - p["joint_log_pdf"][:, 0].mean()  # the best entry per image
        count += 1
    return nll / max(count, 1)


def refiner_preservation_loss(
    pattern: SaccadicViTMultiStatePattern,
    predictor: TransformerSaccadicViTPredictor,
    hidden_states: torch.Tensor,
    context_states: torch.Tensor,
    max_wildcards: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Refined node embeddings ~ inputs: the squared error summed over D,
    averaged over the hidden nodes; aux: the matches' best joint log-pdf."""
    matches = pattern.match(hidden_states, context_states, max_wildcards)
    refined, _ = predictor(hidden_states, context_states, matches)
    err = ((refined.float() - hidden_states.float()) ** 2).sum(-1).mean()
    best = torch.stack([p["joint_log_pdf"][:, 0] for p in matches.values()]).mean()
    return err, {"best_joint_log_pdf": best}


@torch.no_grad()
def trace_losses(trace: Dict[str, np.ndarray],
                 embeddings: SaccadicViTEmbeddings) -> Dict[str, float]:
    """Diagnostics over a `SaccadicViTModel.forward` trace (host-side; the
    serial loop is not differentiated)."""
    emb = np.asarray(trace["embedding"], np.float32)
    pred = np.asarray(trace["predicted_embedding"], np.float32)
    query = np.asarray(trace["query"], np.float32)

    has_pred = np.abs(pred).sum(axis=-1) > 0
    predictive = (float(np.mean(np.sum((pred[has_pred] - emb[has_pred]) ** 2, -1)))
                  if has_pred.any() else 0.0)
    dev = embeddings.position_decoder.weight.device
    decoded = embeddings.decode_position(torch.from_numpy(emb).to(dev)).cpu().numpy()
    positional_recovery = float(np.mean(np.sum((decoded - query) ** 2, -1)))
    raw = np.asarray(trace.get("raw_embedding", emb), np.float32)
    preservation = float(np.mean(np.sum((emb - raw) ** 2, -1)))
    return {"predictive": predictive, "positional_recovery": positional_recovery,
            "preservation": preservation}
