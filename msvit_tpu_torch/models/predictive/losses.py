"""Predictive-encoder training losses (counterpart of
`msvit_tpu/models/predictive/losses.py`).

Each loss re-runs parts of the model: position decoding, re-embedding the
image at the predicted positions, patch decoding.  Variable-length
contexts use the static-max scheme: per-token errors past a sample's
context length are masked before the sum (`sum_error_with_context_lengths`).

The JAX package's three defects, ruled on here:

* `training_loss` weighs a loss only when its weight is a Python float
  there, so an int weight (``query_patch_prediction=1``) drops the loss
  silently.  Fixed: any real number weighs its loss.
* `normalize_latent=True` reads the forward's `input_hidden_state`, which
  is None unless the forward ran with `output_inputs=True`; JAX then fails
  on None.  Here it raises a `ValueError` that names `output_inputs`.
* `patch_mean_bar` normalises its context bar by the count of valid
  context tokens, where `context_patch_prediction` divides by
  `expected_context_length`.  Mirrored: it is a reported bar, and its
  readings are compared across the two packages.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Callable, Dict, Tuple

import torch

from msvit_tpu_torch.models.predictive.config import (
    PredictiveViTConfig, PredictiveViTTrainingConfig)
from msvit_tpu_torch.models.predictive.model import PredictiveViTModel, _config_scale


def sum_error_with_context_lengths(error: torch.Tensor,
                                   context_lengths: torch.Tensor) -> torch.Tensor:
    """Per-token errors [B, N] past each sample's context length masked,
    then summed: [B]."""
    mask = torch.arange(error.shape[-1], device=error.device)[None] < context_lengths[:, None]
    return (error * mask).sum(-1)


def _sq_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x.float().square().sum(dim)


def preservation_loss(model: PredictiveViTModel, pixel_values, output):
    """Output context embeddings ~ the input embeddings."""
    inp = output["input_hidden_state"][:, 1:-1]
    out = output["last_hidden_state"][:, 1:-1]
    err = sum_error_with_context_lengths(_sq_norm(out - inp), output["context_lengths"])
    return err / model.config.expected_context_length, {}


def _prediction_error(model, pixel_values, predicted_state):
    """Decode latents to positions, re-embed the image there, L2 in latent
    space."""
    pos, _ = model.latent_to_position(predicted_state)
    true_state = model.embed(pixel_values, pos)[:, 1:-1]
    return _sq_norm(predicted_state - true_state), {"config": pos, "true_state": true_state}


def context_prediction_loss(model, pixel_values, output):
    err, meta = _prediction_error(model, pixel_values, output["last_hidden_state"][:, 1:-1])
    err = (sum_error_with_context_lengths(err, output["context_lengths"])
           / model.config.expected_context_length)
    return err, {"predicted_context_position": meta["config"],
                 "true_context_state": meta["true_state"]}


def query_prediction_loss(model, pixel_values, output):
    err, meta = _prediction_error(model, pixel_values, output["last_hidden_state"][:, -1:])
    return err[:, 0], {"predicted_query_position": meta["config"][:, 0],
                       "true_query_state": meta["true_state"][:, 0]}


def _patch_prediction_error(model, pixel_values, predicted_state):
    """Latent -> position and orthogonal component -> pixel patch by the
    transposed-conv decoder, against the true glimpse at that position."""
    pos, orthogonal = model.latent_to_position(predicted_state, True)
    emb = model.patch_embeddings
    predicted_patch = emb.latent_to_patch(orthogonal)
    true_patch = emb.position_to_patch(pixel_values, pos)
    diff = (predicted_patch - true_patch).reshape(predicted_patch.shape[:-3] + (-1,))
    return _sq_norm(diff), {"config": pos, "predicted_patch": predicted_patch,
                            "true_patch": true_patch}


def context_patch_prediction_loss(model, pixel_values, output):
    err, meta = _patch_prediction_error(model, pixel_values,
                                        output["last_hidden_state"][:, 1:-1])
    cfg = model.config
    err = (sum_error_with_context_lengths(err, output["context_lengths"])
           / (cfg.expected_context_length * cfg.patch_size**2))
    return err, {"predicted_context_position": meta["config"],
                 "predicted_context_patch": meta["predicted_patch"],
                 "true_context_patch": meta["true_patch"]}


def query_patch_prediction_loss(model, pixel_values, output):
    err, meta = _patch_prediction_error(model, pixel_values,
                                        output["last_hidden_state"][:, -1:])
    return err[:, 0] / model.config.patch_size**2, {
        "predicted_query_position": meta["config"][:, 0],
        "predicted_query_patch": meta["predicted_patch"][:, 0],
        "true_query_patch": meta["true_patch"][:, 0]}


def positional_recovery_loss(model, pixel_values, output):
    """Decoded positions of the context outputs ~ the sampled positions."""
    pos, _ = model.latent_to_position(output["last_hidden_state"][:, 1:-1])
    err = sum_error_with_context_lengths(_sq_norm(pos - output["input_position"]),
                                         output["context_lengths"])
    return err / model.config.expected_context_length, {}


def positional_regularization_loss(model, pixel_values, output):
    """Decoded, unscaled positions (contexts and PRD) near the origin."""
    pos, _ = model.latent_to_position(output["last_hidden_state"][:, 1:])
    scale, shift = _config_scale(model.config, pos.device)
    pos = (pos - shift) / scale
    err = (sum_error_with_context_lengths(_sq_norm(pos)[:, :-1], output["context_lengths"])
           + _sq_norm(pos[:, -1]))
    return err / (model.config.expected_context_length + 1), {}


LOSS2FN: Dict[str, Callable] = {
    "preservation": preservation_loss,
    "context_prediction": context_prediction_loss,
    "query_prediction": query_prediction_loss,
    "context_patch_prediction": context_patch_prediction_loss,
    "query_patch_prediction": query_patch_prediction_loss,
    "positional_recovery": positional_recovery_loss,
    "positional_regularization": positional_regularization_loss,
}

# squared distances between D-dim latents (scaled by `normalize_latent`)
_LATENT_LOSSES = ("preservation", "context_prediction", "query_prediction")


def patch_mean_bar(output: Dict[str, Any], losses_meta: Dict[str, Any],
                   config: PredictiveViTConfig) -> Dict[str, torch.Tensor]:
    """Predict-the-mean baselines of the patch losses: what a constant
    predictor of the batch-mean true patch would score, in the patch
    losses' units (squared error / patch_size^2).  The context bar divides
    by the count of valid context tokens (the JAX package's normaliser,
    mirrored; the loss divides by `expected_context_length`).  Needs the
    meta of `training_loss` with the patch losses on."""
    bars: Dict[str, torch.Tensor] = {}
    p2 = float(config.patch_size**2)
    if "true_query_patch" in losses_meta:
        tq = losses_meta["true_query_patch"].float()  # [B, P, P, C]
        mean = tq.mean(0, keepdim=True)
        bars["query_patch_mean_bar"] = (tq - mean).square().reshape(tq.shape[0], -1) \
            .sum(-1).mean() / p2
    if "true_context_patch" in losses_meta:
        tc = losses_meta["true_context_patch"].float()  # [B, N, P, P, C]
        lengths = output["context_lengths"]
        mask = (torch.arange(tc.shape[1], device=tc.device)[None] < lengths[:, None]).float()
        flat = tc.reshape(tc.shape[0] * tc.shape[1], -1)
        w = mask.reshape(-1)[:, None]
        denom = w.sum().clamp_min(1.0)
        mean = (flat * w).sum(0, keepdim=True) / denom
        err = (flat - mean).square().sum(-1) * w[:, 0]
        bars["context_patch_mean_bar"] = err.sum() / denom / p2
    return bars


def training_loss(
    model: PredictiveViTModel,
    pixel_values: torch.Tensor,
    output: Dict[str, Any],
    train_config: PredictiveViTTrainingConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Weighted sum over the losses with a nonzero weight: (per-sample
    error [B] f32, each loss [B], detached meta)."""
    losses: Dict[str, torch.Tensor] = {}
    meta: Dict[str, torch.Tensor] = {}
    error = torch.zeros(pixel_values.shape[0], device=pixel_values.device)
    if train_config.normalize_latent:
        if output["input_hidden_state"] is None:
            raise ValueError("normalize_latent needs the input embeddings: run the "
                             "forward with output_inputs=True")
        # the detached mean second moment of the input embeddings
        m2 = (output["input_hidden_state"].float().square().sum(-1).mean() + 1e-6).detach()
    for k, weight in dataclasses.asdict(train_config).items():
        if k in LOSS2FN and isinstance(weight, numbers.Real) and weight != 0:
            e, m = LOSS2FN[k](model, pixel_values, output)
            if train_config.normalize_latent and k in _LATENT_LOSSES:
                e = e / m2
            error = error + weight * e
            losses[k] = e
            meta.update({mk: mv.detach() for mk, mv in m.items()})
    return error, losses, meta
