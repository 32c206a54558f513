"""Subsample encoder: coarse-to-fine quadtree token refinement (counterpart
of `msvit_tpu/models/subsample/model.py`).

The quadtree's geometry is static: every box a token can occupy follows
from its tree position alone.  So a full g-ary tree of ``capacity`` slots
is laid out once (`build_quadtree`, numpy tables), every slot is embedded
in one batch (a P x P bicubic lattice per box through
`grid_sample_separable`, one `Linear`, and the position table sampled at
the box center), and the refinement loop runs over static shapes:
validity and lock masks select the live tokens, and a split activates the
children's slots.

Modes: "open" re-encodes [CLS ++ every slot] each iteration under a
key-only mask [B, 1, 1, 1 + cap]; "lock" does the same, and tokens that
decline to split leave later decisions; "freeze" encodes only the
level-`it` slots as queries, with the shallower levels' cached per-layer
states as `context_states` (the trunk concatenates them onto K/V), again
under a key-only mask.

The attention goes through the trunk's dispatch: below 512 keys the plain
path, as in JAX; from 512 keys on the card the fused (K4/K5) or flash (K7)
kernels, which read the key-only mask through a row stride of 0.  At 448 px
and depth 3 (1,361 tokens) "auto" takes K7 in every layer of every open
iteration and in the last freeze iteration.

The policy is a Bernoulli(sigmoid(w)) per slot, w a linear read of the
slot's last cached state in f32.  It draws from an `Rng` (utils/rng.py)
where JAX takes the "policy" key: one `split` per iteration, then
`uniform(shape, 0, 1) < sigmoid(w)`, `jax.random.bernoulli`'s definition,
so a test that hands it `JaxRng` draws JAX's splits.  Cached states are
held in the compute dtype, as in JAX, and the policy reads them cast to
f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msvit_tpu_torch.models.base.model import BaseViTEncoder, Linear, dropout, trunc_normal
from msvit_tpu_torch.models.base.norm import LayerNorm
from msvit_tpu_torch.models.multistate.model import as_rng
from msvit_tpu_torch.models.subsample.config import SubsampleViTConfig
from msvit_tpu_torch.ops.grid_sample import grid_sample, grid_sample_separable
from msvit_tpu_torch.utils.math import linspace

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class QuadTree:
    """Static full-tree tables (numpy).

    corners[s] = ((c00, c01), (c10, c11)): the box's two corners, each in
    (y, x) image order."""

    corners: np.ndarray  # [C, 2, 2] float32
    depth: np.ndarray  # [C] int32
    parent: np.ndarray  # [C] int32 (-1 for roots)
    child_start: np.ndarray  # [C] int32 (-1 for leaves)
    level_offsets: Tuple[int, ...]


def subdivide_boxes(corners: np.ndarray, grid: int) -> np.ndarray:
    """Split boxes [..., 2, 2] into grid^2 children [..., grid^2, 2, 2]."""
    l = np.linspace(1.0, 0.0, grid + 1, dtype=np.float32)
    a = np.stack(np.meshgrid(l[:-1], l[:-1], indexing="ij"), axis=-1)  # [G,G,2]
    b = np.stack(np.meshgrid(l[1:], l[1:], indexing="ij"), axis=-1)
    gg = np.stack([a, b], axis=-2).reshape(grid * grid, 2, 2)  # [G^2, 2(new), 2(xy)]
    grid_points = np.stack([gg, 1.0 - gg], axis=-2)  # [G^2, 2(new), 2(old), 2(xy)]
    return np.sum(corners[..., None, None, :, :] * grid_points, axis=-2)


def build_quadtree(config: SubsampleViTConfig) -> QuadTree:
    g_children = config.children_per_split
    root = np.asarray([[-1.0, -1.0], [1.0, 1.0]], np.float32)

    corners = [subdivide_boxes(root, config.initial_grid_size)]  # level 0
    for _ in range(config.max_depth):
        kids = subdivide_boxes(corners[-1], config.multiplicative_grid_size)
        corners.append(kids.reshape(-1, 2, 2))

    level_sizes = [c.shape[0] for c in corners]
    level_offsets = np.concatenate([[0], np.cumsum(level_sizes)])
    cap = int(level_offsets[-1])

    depth = np.concatenate([np.full(n, k, np.int32) for k, n in enumerate(level_sizes)])
    parent = np.full(cap, -1, np.int32)
    child_start = np.full(cap, -1, np.int32)
    for k in range(config.max_depth):
        off, n = int(level_offsets[k]), level_sizes[k]
        coff = int(level_offsets[k + 1])
        for j in range(n):
            s = off + j
            child_start[s] = coff + j * g_children
            parent[coff + j * g_children: coff + (j + 1) * g_children] = s

    return QuadTree(
        corners=np.concatenate(corners, axis=0).astype(np.float32),
        depth=depth,
        parent=parent,
        child_start=child_start,
        level_offsets=tuple(int(o) for o in level_offsets),
    )


class SubsampleViTEmbeddings(nn.Module):
    """Embed every quadtree slot: each box resampled bicubically (zeros
    padding) to P x P, projected by one `Linear` over (p1, p2, c), plus the
    position table (without its CLS row) sampled bicubically at the box
    center.  Keys: ``patch_projection.*``, ``position_embeddings
    [1, num_patches + 1, D]``."""

    def __init__(self, config: SubsampleViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        p, c, d = config.patch_size, config.num_channels, config.hidden_size
        self.patch_projection = Linear(p * p * c, d, True, config, generator)
        self.position_embeddings = nn.Parameter(
            trunc_normal((1, config.num_patches + 1, d), config.initializer_range,
                         generator).to(config.policy.param))

    def forward(
        self,
        pixel_values: torch.Tensor,  # [B, H, W, C]
        corners: torch.Tensor,  # [S, 2, 2], (y, x) order
        return_pixel_values: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        p = cfg.patch_size
        b, s = pixel_values.shape[0], corners.shape[0]
        lin = linspace(-1.0 + 1.0 / p, 1.0 - 1.0 / p, p, corners.device)
        center = (corners[:, 0] + corners[:, 1]) / 2.0  # [S, 2]
        half = (corners[:, 1] - corners[:, 0]) / 2.0
        ys = center[:, 0:1] + lin[None] * half[:, 0:1]  # [S, P]
        xs = center[:, 1:2] + lin[None] * half[:, 1:2]
        patches = grid_sample_separable(pixel_values, ys.expand(b, s, p),
                                        xs.expand(b, s, p), "bicubic", "zeros")
        x = self.patch_projection(patches.reshape(b, s, -1))

        k = int(round(cfg.num_patches**0.5))
        table = self.position_embeddings[0, 1:].reshape(1, k, k, cfg.hidden_size)
        pos = grid_sample(table, center.flip(-1)[None], "bicubic", "zeros")  # [1, S, D]
        x = x + pos.to(x.dtype)
        rate = cfg.hidden_dropout_prob
        if rate > 0.0 and self.training:
            x = dropout(x, rate, None)
        return x, (patches if return_pixel_values else None)


class SubsampleViTModel(nn.Module):
    """The coarse-to-fine loop.  State-dict keys: ``cls_token [1, 1, D]``,
    ``embeddings.*``, ``encoder.layer.i.*``, ``projection.*`` (the policy,
    D -> 1 in f32), ``layernorm.*``."""

    def __init__(self, config: SubsampleViTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        config.check_supported()
        if config.nesting_mode not in ("open", "lock", "freeze"):
            raise ValueError(config.nesting_mode)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        g, d, policy = generator, config.hidden_size, config.policy
        self.tree = build_quadtree(config)
        self.register_buffer("corners", torch.from_numpy(self.tree.corners), persistent=False)
        self.register_buffer("depth", torch.from_numpy(self.tree.depth).long(),
                             persistent=False)
        self.register_buffer("parent", torch.from_numpy(self.tree.parent).long(),
                             persistent=False)
        self.cls_token = nn.Parameter(
            trunc_normal((1, 1, d), config.initializer_range, g).to(policy.param))
        self.embeddings = SubsampleViTEmbeddings(config, g)
        self.encoder = BaseViTEncoder(config, g)
        self.projection = Linear(d, 1, True, config, g)
        self.projection.compute_dtype = torch.float32
        self.layernorm = LayerNorm(d, config.layer_norm_eps, torch.float32, policy.param)
        if device is not None:
            self.to(device)

    def forward(
        self,
        pixel_values: torch.Tensor,  # [B, H, W, C]
        rng=None,
        output_logs: bool = False,
        return_pixel_values: bool = False,
    ) -> Dict[str, Any]:
        """`rng`: an `Rng` (or an int seed; None: one from the default CPU
        generator) for the policy's draws.  Dropout, if the config has it,
        draws from the default generators while training."""
        cfg = self.config
        tree = self.tree
        b, dev = pixel_values.shape[0], pixel_values.device
        cap, n_layers, d = cfg.capacity, cfg.num_hidden_layers, cfg.hidden_size
        compute = cfg.policy.compute
        rng = as_rng(rng)
        depth, parent = self.depth, self.parent
        input_state, patch_pixels = self.embeddings(
            pixel_values, self.corners, return_pixel_values)  # [B, cap, D]

        g = cfg.children_per_split
        valid = torch.zeros(b, cap, dtype=torch.bool, device=dev)
        valid[:, :cfg.num_roots] = True
        lock = torch.zeros_like(valid)
        cached = torch.zeros(b, cap, n_layers + 1, d, dtype=compute, device=dev)
        cls_cached = None
        cum_log_prob = torch.zeros(b, device=dev)
        convergence = valid
        logs = {"valid_masks": [], "corners": [], "depths": [], "subsample_logits": [],
                "subsample_masks": []}
        cls_b = self.cls_token.expand(b, 1, d).to(compute)
        zero_col = torch.zeros(b, 1, device=dev)
        if cfg.use_weighted_tokens:
            bias_vec = -math.log(g) * depth.float()
        else:
            bias_vec = torch.zeros(cap, device=dev)

        def key_mask(keep, bias):
            return torch.where(keep, 0.0, NEG_INF) + bias[None]

        for it in range(cfg.max_depth + 1):
            ctx = None
            if cfg.nesting_mode in ("open", "lock"):
                # [CLS ++ every slot] under the validity mask
                amask = torch.cat([zero_col, key_mask(valid, bias_vec)], dim=-1)
                hidden = torch.cat([cls_b, input_state], dim=1)
            else:
                # freeze: the only live slots at iteration `it` are level
                # `it`'s (every earlier live slot either locked or split);
                # queries are that slice, context the shallower prefix
                lo, hi = tree.level_offsets[it], tree.level_offsets[it + 1]
                live = valid[:, lo:hi] & ~lock[:, lo:hi]
                cols = [zero_col, key_mask(live, bias_vec[lo:hi])]
                if lo > 0:
                    cols.append(key_mask(valid[:, :lo] & lock[:, :lo], bias_vec[:lo]))
                    ctx = [cached[:, :lo, layer] for layer in range(n_layers)]
                amask = torch.cat(cols, dim=-1)  # [B, 1 + (hi - lo) + lo]
                hidden = torch.cat([cls_b, input_state[:, lo:hi]], dim=1)

            _, all_hidden, _ = self.encoder(
                hidden, context_states=ctx, attention_mask=amask[:, None, None, :],
                output_hidden_states=True)
            stacked = torch.stack(all_hidden, dim=-2).to(compute)  # [B, Nq, L+1, D]
            cls_cached = stacked[:, :1]
            if cfg.nesting_mode == "freeze":
                upd = convergence[:, lo:hi, None, None]
                cached = torch.cat([cached[:, :lo],
                                    torch.where(upd, stacked[:, 1:], cached[:, lo:hi]),
                                    cached[:, hi:]], dim=1)
            else:
                cached = stacked[:, 1:]

            # the subdivision policy: Bernoulli(sigmoid(w)) per slot
            w = self.projection(cached[:, :, -1, :].float())[..., 0]  # [B, cap]
            rng, step_rng = rng.split(2)
            split = step_rng.uniform((b, cap), 0.0, 1.0, dev) < torch.sigmoid(w)
            log_prob = torch.where(split, F.logsigmoid(w), F.logsigmoid(-w))
            subsample_mask = split & convergence
            if cfg.nesting_mode in ("lock", "freeze"):
                lock = lock | ~split

            if output_logs:
                logs["valid_masks"].append(valid)
                logs["corners"].append(self.corners)
                logs["depths"].append(depth)
                logs["subsample_logits"].append(torch.where(convergence, w, 0.0))
                logs["subsample_masks"].append(subsample_mask)

            if it < cfg.max_depth:
                cum_log_prob = cum_log_prob + torch.where(convergence, log_prob, 0.0).sum(-1)
                # activate the children of split slots; invalidate the parents
                parent_split = subsample_mask[:, parent.clamp_min(0)] & (parent >= 0)[None]
                valid = (valid & ~subsample_mask) | parent_split
                # new children start unlocked, with a zeroed cache
                lock = lock & ~parent_split
                cached = torch.where(parent_split[:, :, None, None],
                                     torch.zeros((), dtype=compute, device=dev), cached)

            convergence = valid & ~lock

        seq = torch.cat([cls_cached[:, :, -1], cached[:, :, -1]], dim=1)
        return {
            "last_hidden_state": self.layernorm(seq),  # [B, 1 + cap, D] f32
            "last_valid_mask": valid,
            "log_prob": cum_log_prob,
            "depths": depth,
            "pixel_values": patch_pixels,
            "logs": logs if output_logs else None,
        }


def _per_sample_loss(logits: torch.Tensor, labels: torch.Tensor,
                     problem_type: str) -> torch.Tensor:
    """The per-sample (unreduced) loss of each problem type."""
    if problem_type == "regression":
        return ((logits - labels) ** 2).mean(-1)
    if problem_type == "single_label_classification":
        return -F.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None])[:, 0]
    if problem_type == "multi_label_classification":
        return (logits.clamp_min(0) - logits * labels
                + torch.log1p(torch.exp(-logits.abs()))).mean(-1)
    raise ValueError(problem_type)


class SubsampleViTForImageClassification(nn.Module):
    """CLS ++ the (depth-weighted) mean of the valid patch tokens -> a
    linear head in f32; a per-sample loss.  Keys: ``model.*``,
    ``classifier.*``."""

    def __init__(self, config: SubsampleViTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.model = SubsampleViTModel(config, generator=generator)
        self.classifier = Linear(2 * config.hidden_size, config.num_labels, True, config,
                                 generator)
        self.classifier.compute_dtype = torch.float32
        if device is not None:
            self.to(device)

    def forward(
        self,
        pixel_values: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        rng=None,
        output_logs: bool = False,
        return_pixel_values: bool = False,
    ) -> Dict[str, Any]:
        cfg = self.config
        outputs = self.model(pixel_values, rng=rng, output_logs=output_logs,
                             return_pixel_values=return_pixel_values)
        seq, valid = outputs["last_hidden_state"], outputs["last_valid_mask"]
        if cfg.use_weighted_tokens:
            # the base is the grid multiplier, not the children per split
            weights = valid * torch.pow(float(cfg.multiplicative_grid_size),
                                        -6.0 * outputs["depths"].float()[None])
        else:
            weights = valid.float()
        avg = (weights[..., None] * seq[:, 1:]).sum(1) / weights.sum(-1, keepdim=True)
        logits = self.classifier(torch.cat([seq[:, 0], avg], dim=-1))
        loss = None if labels is None else _per_sample_loss(logits, labels, cfg.problem_type)
        outputs.update({"classifier_logits": logits, "loss": loss})
        return outputs


def reinforce_loss(per_sample: torch.Tensor, log_prob: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """REINFORCE: the detached per-sample loss standardised over the batch
    (population variance, train-mode BatchNorm1d without affine) times the
    episode's log-probability, averaged."""
    reward = per_sample.detach()
    normalized = (reward - reward.mean()) / torch.sqrt(reward.var(correction=0) + eps)
    return (normalized * log_prob).mean()
