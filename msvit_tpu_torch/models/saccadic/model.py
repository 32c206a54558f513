"""Saccadic top-level model: the serial saccade controller (counterpart of
`msvit_tpu/models/saccadic/model.py`).

A host-side controller around three tensor steps (embed a glimpse, decode a
position, match and refine), as in JAX: the loop is data-dependent and
serial by design, so it lives in Python with numpy bookkeeping while every
tensor op runs on the model's device.  Per step:

1. pop (proposing edge, predicted embedding) from the queue; decode the
   next query from the predicted embedding, or start at the image center;
2. embed the glimpse at the query;
3. beam-match the pattern bank against [new node ++ converged history]
   with at most one wildcard: the one-wildcard matches are the predictive
   edges proposing where to look next;
4. refine the new node's embedding with the transformer refiner;
5. convergence: a saccade that revisits itself (spatial or latent distance
   below the threshold) or reaches its maximum length ends in a terminal
   node, which binds the proposing edge's wildcard and queues the step's
   proposals; a node that lands near a historic one closes a loop onto
   that node's terminal index.

The history fed to the matcher has a static length: `max_trace_length`
rows, padded with far sentinel embeddings whose log-pdf is ~ -inf under
any pattern, so the beam never binds them.  Patterns are read in sorted
key order and proposals ranked with numpy's `argsort`, as the JAX
controller does with what its jitted step returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from msvit_tpu_torch.models.saccadic.config import SaccadicViTConfig
from msvit_tpu_torch.models.saccadic.embeddings import SaccadicViTEmbeddings
from msvit_tpu_torch.models.saccadic.pattern import WILDCARD, SaccadicViTMultiStatePattern
from msvit_tpu_torch.models.saccadic.refiner import TransformerSaccadicViTPredictor

SENTINEL = 1e6  # far-away pad embedding: log-pdf ~ -inf under any pattern


@dataclasses.dataclass
class Edge:
    """A pattern instance over saccade nodes."""

    complexity: int
    pattern_index: int
    node_indices: np.ndarray  # [K]; -1 = wildcard (unexplored)
    joint_log_pdf: float


class SaccadicViTModel(nn.Module):
    """The three modules and the serial controller.  Keys:
    ``embeddings.*``, ``pattern.*``, ``predictor.*``.  Weights are drawn
    on the CPU from `generator` (seed 0 when None), then moved to
    `device`."""

    def __init__(self, config: SaccadicViTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        config.check_supported()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.embeddings = SaccadicViTEmbeddings(config, generator)
        self.pattern = SaccadicViTMultiStatePattern(config, generator)
        self.predictor = TransformerSaccadicViTPredictor(config, generator)
        if device is not None:
            self.to(device)

    # ---------------- tensor steps ----------------

    def embed(self, pixel_values: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        """pixel_values [1, H, W, C], query [dof] -> [D] f32."""
        return self.embeddings(pixel_values, query[None])[0].float()

    def decode(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.embeddings.decode_position(embedding)

    def match_refine(self, hidden: torch.Tensor, context: torch.Tensor):
        """hidden [1, D], context [C_pad, D] (sentinel-padded) -> (patterns,
        the refined hidden node [D])."""
        patterns = self.pattern.match(hidden[None], context[None], 1)
        refined, _ = self.predictor(hidden[None], context[None], patterns)
        return patterns, refined[0, 0]

    # ---------------- controller ----------------

    @torch.no_grad()
    def forward(
        self,
        pixel_values: torch.Tensor,  # [1, H, W, C]: one image (serial model)
        convergence_distance: str = "spatial",
        absolute_threshold: float = 0.1,
        max_trace_length: int = 16,
        max_saccade_length: int = 6,
        max_proposals: int = 2,
    ) -> Dict[str, Any]:
        cfg = self.config
        d, c_pad = cfg.hidden_size, max_trace_length
        dev = pixel_values.device

        history: List[Dict[str, np.ndarray]] = []  # converged nodes
        saccade: List[Dict[str, np.ndarray]] = []  # the current saccade
        terminal_indices: List[int] = []
        constructed_edges: List[Edge] = []
        queue: List[Tuple[Optional[Edge], Optional[np.ndarray]]] = [(None, None)]
        proposed_edges: List[Tuple[Edge, np.ndarray]] = []

        def context_array() -> torch.Tensor:
            ctx = np.full((c_pad, d), SENTINEL, np.float32)
            for i, t in enumerate(history[:c_pad]):
                ctx[i] = t["embedding"]
            return torch.from_numpy(ctx).to(dev)

        def min_distance(timestep, window):
            key = "query" if convergence_distance == "spatial" else "embedding"
            dists = [float(np.linalg.norm(timestep[key] - w[key])) for w in window]
            i = int(np.argmin(dists))
            return dists[i], i

        it = 0
        while it < max_trace_length and queue:
            proposing_edge, predicted_embedding = queue.pop(0)
            if predicted_embedding is None:
                next_query = np.zeros((cfg.dof,), np.float32)
            else:
                next_query = self.decode(torch.from_numpy(predicted_embedding).to(dev)) \
                    .cpu().numpy()
            embedding = self.embed(pixel_values, torch.from_numpy(next_query).to(dev))
            patterns, refined = self.match_refine(embedding[None], context_array())
            embedding, refined = embedding.cpu().numpy(), refined.float().cpu().numpy()

            # predictive edges: the one-wildcard matches, best first
            step_proposals: List[Tuple[Edge, np.ndarray]] = []
            for (k, n_wild), p in sorted(patterns.items()):
                if n_wild != 1:
                    continue
                joint = p["joint_log_pdf"][0].cpu().numpy()
                index = p["pattern_index"][0].cpu().numpy()
                nodes = p["node_indices"][0].cpu().numpy()
                means = p["conditional_mean"][0, :, 0].cpu().numpy()
                for w in np.argsort(-joint)[:max_proposals]:
                    edge = Edge(complexity=k, pattern_index=int(index[w]),
                                node_indices=nodes[w].copy(),
                                joint_log_pdf=float(joint[w]))
                    step_proposals.append((edge, means[w]))
            step_proposals.sort(key=lambda e: -e[0].joint_log_pdf)

            timestep = {
                "predicted_embedding": (predicted_embedding if predicted_embedding is not None
                                        else np.zeros((d,), np.float32)),
                "query": next_query,
                "embedding": refined,
                "raw_embedding": embedding,
            }
            saccade.append(timestep)

            terminal_index: Optional[int] = None
            if len(saccade) == max_saccade_length or (
                    len(saccade) > 1
                    and min_distance(timestep, saccade[:-1])[0] < absolute_threshold):
                terminal_index = len(history) + len(saccade) - 1
            elif history:
                dist, idx = min_distance(timestep, history)
                if dist < absolute_threshold:
                    terminal_index = int(history[idx]["terminal_index"])

            if terminal_index is not None:
                for t in saccade:
                    t["terminal_index"] = np.asarray(terminal_index)
                history.extend(saccade)
                saccade = []
                if proposing_edge is not None:
                    unfilled = proposing_edge.node_indices == WILDCARD
                    if unfilled.sum() == 1:
                        proposing_edge.node_indices = np.where(
                            unfilled, terminal_index, proposing_edge.node_indices)
                        constructed_edges.append(proposing_edge)
                if terminal_index not in terminal_indices:
                    terminal_indices.append(terminal_index)
                    queue = step_proposals + queue
            elif step_proposals:
                # continue the saccade along the most likely predictive edge
                queue.insert(0, step_proposals[0])

            proposed_edges = step_proposals
            it += 1

        trace = history + saccade
        keys = ("query", "embedding", "raw_embedding", "predicted_embedding")
        return {
            "trace": {k: np.stack([t[k] for t in trace]) for k in keys} if trace else {},
            "terminal_indices": terminal_indices,
            "constructed_edges": constructed_edges,
            "num_steps": it,
            "proposed_edges": proposed_edges,
        }
