"""Batched lockstep saccade runner (counterpart of
`msvit_tpu/models/saccadic/batched.py`).

Every image advances one glimpse per step.  Per image the state holds the
current query, a fixed-length history of (query, embedding) pairs and a
saccade-age counter.  Each step embeds the glimpse, beam-matches the
patterns against [new node ++ history], takes the best one-wildcard edge's
conditional mean as the predicted embedding and decodes the next query.
An image whose query revisits its recent history (minimum distance below
the threshold) or whose saccade reaches its maximum length converges: its
next query is the image center and its age restarts.

JAX's `lax.scan` becomes a Python loop over `num_steps` with static
shapes; nothing in it reads a value back to the host (the history is
updated by a one-hot select, not by indexing with a device value).
"""

from __future__ import annotations

from typing import Dict

import torch

from msvit_tpu_torch.models.saccadic.embeddings import SaccadicViTEmbeddings
from msvit_tpu_torch.models.saccadic.model import SENTINEL
from msvit_tpu_torch.models.saccadic.pattern import SaccadicViTMultiStatePattern


@torch.no_grad()
def batched_saccade_run(
    embeddings: SaccadicViTEmbeddings,
    pattern: SaccadicViTMultiStatePattern,
    pixel_values: torch.Tensor,  # [B, H, W, C]
    num_steps: int,
    max_saccade_length: int = 6,
    absolute_threshold: float = 0.1,
    convergence_distance: str = "spatial",
) -> Dict[str, torch.Tensor]:
    """Returns the trace: queries [T, B, dof], embeddings [T, B, D],
    predicted [T, B, D], converged [T, B] (the step ended that image's
    saccade), num_saccades [B] (int32)."""
    cfg = embeddings.config
    b, dev = pixel_values.shape[0], pixel_values.device
    d, dof, hist_cap = cfg.hidden_size, cfg.dof, num_steps

    query = torch.zeros(b, dof, device=dev)  # the image center (sample_initial)
    hist_q = torch.full((b, hist_cap, dof), SENTINEL, device=dev)
    hist_e = torch.full((b, hist_cap, d), SENTINEL, device=dev)
    age = torch.zeros(b, dtype=torch.int32, device=dev)
    n_sacc = torch.zeros(b, dtype=torch.int32, device=dev)
    step_idx = torch.arange(hist_cap, device=dev)[None, :]
    trace = {"queries": [], "embeddings": [], "predicted": [], "converged": []}

    for _ in range(num_steps):
        emb = embeddings(pixel_values, query).float()  # [B, D]
        matches = pattern.match(emb[:, None, :], hist_e, 1)
        # the best one-wildcard edge across complexities -> the prediction
        best_pdf = torch.full((b,), -torch.inf, device=dev)
        predicted = torch.zeros(b, d, device=dev)
        for (_k, n_wild), p in matches.items():
            if n_wild != 1:
                continue
            pdf = p["joint_log_pdf"][:, 0]  # beams sorted, best first
            take = pdf > best_pdf
            best_pdf = torch.where(take, pdf, best_pdf)
            predicted = torch.where(take[:, None], p["conditional_mean"][:, 0, 0], predicted)
        next_query = embeddings.decode_position(predicted)  # [B, dof]

        # convergence: a revisit of the recent window, or a saccade too long
        key_now, window = (query, hist_q) if convergence_distance == "spatial" else (emb, hist_e)
        dist = torch.linalg.vector_norm(window - key_now[:, None, :], dim=-1)
        in_window = step_idx < age.clamp_max(hist_cap)[:, None]
        min_dist = torch.where(in_window, dist, torch.inf).amin(-1)
        converged = (min_dist < absolute_threshold) | (age + 1 >= max_saccade_length)

        # record into the history (age indexes within the current saccade)
        slot = (step_idx == age.clamp(0, hist_cap - 1)[:, None])[..., None]
        hist_q = torch.where(slot, query[:, None], hist_q)
        hist_e = torch.where(slot, emb[:, None], hist_e)

        for key, val in (("queries", query), ("embeddings", emb), ("predicted", predicted),
                         ("converged", converged)):
            trace[key].append(val)
        # converged images restart at the center with a fresh saccade
        query = torch.where(converged[:, None], 0.0, next_query)
        age = torch.where(converged, 0, age + 1).to(torch.int32)
        n_sacc = n_sacc + converged.to(torch.int32)

    out = {k: torch.stack(v) for k, v in trace.items()}
    out["num_saccades"] = n_sacc
    return out
