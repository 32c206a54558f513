"""Multi-state encoder (counterpart of `msvit_tpu/models/multistate/model.py`).

* The cluster axis is padded to `config.max_clusters` slots with a count of
  valid clusters, so the mask and the TX/RX token tensors keep one shape
  through the network.
* The structured attention mask comes from broadcast compares on cluster
  ids: (a) intra-cluster token <-> token, (b) TX_c -> the tokens of c,
  (c) tokens -> their RX, (d) every valid RX -> every valid TX.  Layout:
  TX_c at 2c, RX_c at 2c + 1, then the N patch tokens.
* Masking is soft: an additive f32 penalty `where(mask, 0,
  -attention_mask_inf)`.
* Re-clustering duplicates each parent's TX/RX pair onto its children with
  cumsum + `searchsorted(right=True)`, in pooled mode (ids global across
  the batch) and per image.
* The layers are the base trunk's `BaseViTLayer`.  At the bench shape
  (816 tokens, masked) its attention takes the fused kernels on the card
  (`ops/attention.py`): K5, and under autograd K5-lse with the K6
  backward; at 448 px (3168 tokens) the flash kernels: K7, and under
  autograd K7-lse with K6.  The last layer, whose RX -> TX probabilities
  are an output, takes the plain path.
* Banded mode (`config.banded_attention`, ignored under
  `output_attentions`): the tokens are kept sorted by cluster id (a stable
  sort, as `jnp.argsort`: ids tie everywhere, and another order of ties
  would move every row block's band), the trunk layers get a
  `BandedSegments` in place of the mask (`ops/banded_attention.py`, K10 for
  the token rows), clustering sees the tokens in their original order (its
  anchor draws are positional: banded and dense modes then cluster alike),
  the last layer builds the dense mask over the sorted tokens, and every
  output is unsorted.
* `MultiStateViTForImageClassification`: a linear head over the
  occupancy-weighted mean of the TX tokens, the fine-tuning story (TX/RX
  tokens and the head train, the trunk frozen; gradients flow through
  every layer).

Clustering sees `detach()`ed f32 hidden states and draws from an `Rng`
(utils/rng.py) split in the JAX package's order.  Cluster counts stay on
the device.  Dropout and drop-path (``self.training`` stands for JAX's
``deterministic=False``) draw from seeded generators, never the global
RNG: a forward draws one seed from its `generator`; the embeddings take
`fold_in(seed, 0)` and block i `fold_in(fold_in(seed, 1), i)`, as
`ViTModel` does.  `compress_tokens_with_cluster_indices` (the TX
compression by least squares) lies on no path, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

import torch.nn.functional as F

from msvit_tpu_torch.models.base.model import (
    BaseViTLayer, Linear, is_stochastic, trunc_normal)
from msvit_tpu_torch.models.base.vit import ViTEmbeddings
from msvit_tpu_torch.models.clustering import cluster, max_children_bound
from msvit_tpu_torch.models.multistate.config import MultiStateViTConfig
from msvit_tpu_torch.ops.banded_attention import BandedSegments
from msvit_tpu_torch.utils.math import multiclass_logits
from msvit_tpu_torch.utils.profiling import span
from msvit_tpu_torch.utils.rng import Rng, draw_seed, fold_in


def as_rng(rng) -> Any:
    """An `Rng` (or any object with its methods) as given, an int as the
    seed of one, None as one seeded from the default CPU generator."""
    if rng is None:
        return Rng(draw_seed(None))
    if isinstance(rng, int):
        return Rng(rng)
    return rng


def build_multistate_attention_mask(
    cluster_indices: torch.Tensor,  # [B, N] int
    n_clusters,  # [] or [B] int: the number of valid clusters
    max_clusters: int,
) -> torch.Tensor:
    """Bool mask [B, 1, 2C+N, 2C+N] with the four blocks above."""
    ci = cluster_indices
    b, n = ci.shape
    c = max_clusters
    ids = torch.arange(c, device=ci.device)
    n_clusters = torch.as_tensor(n_clusters, device=ci.device).broadcast_to((b,))
    cvalid = ids[None] < n_clusters[:, None]  # [B, C]
    tok_in_c = ci[:, None, :] == ids[None, :, None]  # [B, C, N]

    mask = torch.zeros((b, 2 * c + n, 2 * c + n), dtype=torch.bool, device=ci.device)
    mask[:, 2 * c:, 2 * c:] = ci[:, :, None] == ci[:, None, :]  # (a)
    mask[:, 0:2 * c:2, 2 * c:] = tok_in_c  # (b) rows of TX_c
    mask[:, 2 * c:, 1:2 * c:2] = tok_in_c.transpose(1, 2)  # (c) columns of RX_c
    mask[:, 1:2 * c:2, 0:2 * c:2] = cvalid[:, :, None] & cvalid[:, None, :]  # (d)
    return mask[:, None]


def soft_mask(mask: torch.Tensor, config: MultiStateViTConfig) -> torch.Tensor:
    """The additive f32 penalty: 0 where `mask`, -attention_mask_inf
    elsewhere."""
    return torch.where(mask, 0.0, -config.attention_mask_inf).to(torch.float32)


def recluster(config: MultiStateViTConfig, hidden: torch.Tensor,
              cluster_indices: torch.Tensor, cluster_tokens: torch.Tensor,
              key, parents_bound: int, layer: Optional[int] = None):
    """One clustering event (before layer `layer`): the children of every
    current cluster, the parents' TX/RX pairs duplicated onto them.  Returns
    (cluster_indices [B, N], cluster_tokens [B, C, 2, D], n_clusters [] or
    [B], the next call's static parent bound).  The clustering call is the
    span `msvit.recluster` (attr `layer`)."""
    c = config.max_clusters
    b, _, d = hidden.shape
    with span("msvit.recluster", layer=layer):
        child_indices, n_children = cluster(
            config.clustering, cluster_indices, hidden.detach().float(), key,
            max_parents=parents_bound)
    cum = n_children.cumsum(-1)
    ids = torch.arange(c, device=hidden.device)
    if n_children.ndim == 1:  # pooled: one parent map for the batch
        parent_of = torch.searchsorted(cum, ids, right=True).clamp(0, c - 1)
        cluster_tokens = cluster_tokens[:, parent_of]
        n_clusters = cum[-1].clamp_min(1)
    else:  # per image
        parent_of = torch.searchsorted(cum, ids.expand(b, c).contiguous(),
                                       right=True).clamp(0, c - 1)
        cluster_tokens = torch.gather(
            cluster_tokens, 1, parent_of[:, :, None, None].expand(b, c, 2, d))
        n_clusters = cum[:, -1].clamp_min(1)
    return (child_indices, cluster_tokens, n_clusters,
            max_children_bound(config.clustering, parents_bound))


class SortedTokens:
    """The banded mode's token order: `order` maps a sorted position to the
    original token index, `inv` back (identity while `active` is False,
    which makes every method a no-op)."""

    def __init__(self, active: bool, b: int, n: int, device):
        self.active = active
        self.inv = torch.arange(n, device=device).expand(b, n)

    def unsort(self, arr: torch.Tensor) -> torch.Tensor:
        """`arr` [B, N, ...] in sorted order -> original order."""
        if not self.active:
            return arr
        idx = self.inv.reshape(self.inv.shape + (1,) * (arr.ndim - 2))
        return torch.gather(arr, 1, idx.expand(arr.shape))

    def resort(self, child_indices: torch.Tensor, hidden: torch.Tensor):
        """Sort original-order `hidden` [B, N, D] by the new ids (a stable
        sort); returns (hidden, cluster ids) in the sorted order."""
        order = torch.argsort(child_indices, dim=1, stable=True)
        self.inv = torch.argsort(order, dim=1)
        hidden = torch.gather(hidden, 1, order[..., None].expand(hidden.shape))
        return hidden, torch.gather(child_indices, 1, order)


def initial_cluster_tokens(tx: torch.Tensor, rx: torch.Tensor, b: int, c: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """[B, C, 2, D]: the TX/RX pair in every slot."""
    return torch.stack([tx, rx]).to(dtype)[None, None].expand(b, c, 2, tx.shape[-1])


class MultiStateViTEncoderBackbone(nn.Module):
    """The layer loop with clustering events at layers
    i >= pregeneration_period with i % generation_period == 0."""

    def __init__(self, config: MultiStateViTConfig, generator: torch.Generator):
        super().__init__()
        config.check_supported()
        self.config = config
        d, std, param = config.hidden_size, config.initializer_range, config.policy.param
        self.transmitter_token = nn.Parameter(trunc_normal((d,), std, generator).to(param))
        self.receiver_token = nn.Parameter(trunc_normal((d,), std, generator).to(param))
        self.layer = nn.ModuleList(
            BaseViTLayer(config, generator) for _ in range(config.num_hidden_layers))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, N, D]
        rng=None,
        output_hidden_states: bool = False,
        output_cluster_indices: bool = False,
        output_cluster_tokens: bool = False,
        output_attentions: bool = False,
        seed: Optional[int] = None,
    ) -> Dict[str, Any]:
        """`seed`: block i draws its dropout and drop-path masks from
        `fold_in(seed, i)`; None while training with either draws one seed
        from the default CPU generator."""
        cfg = self.config
        if seed is None and self.training and is_stochastic(cfg):
            seed = draw_seed(None)
        b, n, _ = hidden_states.shape
        c = cfg.max_clusters
        rng = as_rng(rng)
        dev = hidden_states.device

        cluster_tokens = initial_cluster_tokens(
            self.transmitter_token, self.receiver_token, b, c, hidden_states.dtype)
        cluster_indices = torch.zeros((b, n), dtype=torch.long, device=dev)
        n_clusters = torch.ones((), dtype=torch.long, device=dev)
        banded = cfg.banded_attention and not output_attentions
        sort = SortedTokens(banded, b, n, dev)
        mask = None if banded else build_multistate_attention_mask(cluster_indices, n_clusters, c)

        collect: Dict[str, list] = {
            "hidden_states": [hidden_states],
            "cluster_indices": [cluster_indices],
            "cluster_tokens": [cluster_tokens],
            "intracluster_attentions": [],
            "transmitter_to_cluster_attentions": [],
            "cluster_to_receiver_attentions": [],
            "receiver_to_transmitter_attentions": [],
        }
        rx_to_tx = None
        parents_bound = 1
        for i, layer in enumerate(self.layer):
            if i >= cfg.pregeneration_period and i % cfg.generation_period == 0:
                rng, step_key = rng.split(2)
                h_orig = sort.unsort(hidden_states)
                child, cluster_tokens, n_clusters, parents_bound = recluster(
                    cfg, h_orig, sort.unsort(cluster_indices), cluster_tokens, step_key,
                    parents_bound, i)
                if banded:
                    hidden_states, cluster_indices = sort.resort(child, h_orig)
                else:
                    cluster_indices = child
                    mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)

            concat = torch.cat([cluster_tokens.reshape(b, 2 * c, -1), hidden_states], 1)
            # probabilities are an output only of the last layer (RX -> TX)
            # or when per-layer attentions are asked for
            need_probs = output_attentions or i == cfg.num_hidden_layers - 1
            seed_i = None if seed is None else fold_in(seed, i)
            if banded and not need_probs:
                concat, probs = layer(concat, seed=seed_i, banded_segments=BandedSegments(
                    cluster_indices, n_clusters, c, cfg.attention_mask_inf))
            else:
                if banded:  # the last layer: dense, the mask over sorted tokens
                    mask = build_multistate_attention_mask(cluster_indices, n_clusters, c)
                concat, probs = layer(concat, attention_mask=soft_mask(mask, cfg),
                                      output_attentions=need_probs, seed=seed_i)
            cluster_tokens = concat[:, :2 * c].reshape(b, c, 2, -1)
            hidden_states = concat[:, 2 * c:]

            if need_probs:
                rx_to_tx = probs[:, :, 1:2 * c:2, 0:2 * c:2]
            if output_hidden_states:
                collect["hidden_states"].append(sort.unsort(hidden_states))
            if output_cluster_indices:
                collect["cluster_indices"].append(sort.unsort(cluster_indices))
            if output_cluster_tokens:
                collect["cluster_tokens"].append(cluster_tokens)
            if output_attentions:
                collect["intracluster_attentions"].append(probs[:, :, 2 * c:, 2 * c:])
                collect["transmitter_to_cluster_attentions"].append(
                    probs[:, :, 0:2 * c:2, 2 * c:])
                collect["cluster_to_receiver_attentions"].append(
                    probs[:, :, 2 * c:, 1:2 * c:2])
                collect["receiver_to_transmitter_attentions"].append(rx_to_tx)

        return {
            "last_hidden_state": sort.unsort(hidden_states),
            "last_cluster_tokens": cluster_tokens,
            "last_cluster_indices": sort.unsort(cluster_indices),
            "num_clusters": n_clusters,
            "last_receiver_to_transmitter_attentions": rx_to_tx,
            **{k: (v if v else None) for k, v in collect.items()},
        }


class MultiStateViTEncoderModel(nn.Module):
    """Embeddings without CLS -> backbone -> pooler (the TX tokens and the
    last layer's RX -> TX attentions).

    Weights are drawn on the CPU from `generator` (seed 0 when None), the
    embeddings' first, then moved to `device`.  State-dict keys:
    ``embeddings.*``, ``backbone.{transmitter,receiver}_token``,
    ``backbone.layer.{i}.*``."""

    def __init__(
        self,
        config: MultiStateViTConfig,
        add_pooling_layer: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        config.check_supported()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.add_pooling_layer = add_pooling_layer
        self.embeddings = ViTEmbeddings(config, False, generator)
        self.backbone = MultiStateViTEncoderBackbone(config, generator)
        if device is not None:
            self.to(device)

    def forward(self, pixel_values: torch.Tensor, rng=None,
                generator: Optional[torch.Generator] = None,
                **output_kwargs: bool) -> Dict[str, Any]:
        """pixel_values [B, H, W, C] NHWC; `rng` (clustering) an `Rng`, an
        int seed, or None (a seed from the default CPU generator);
        `generator` feeds dropout and drop-path while training."""
        g_emb, seed = None, None
        if self.training and is_stochastic(self.config):
            base = draw_seed(generator)
            g_emb = torch.Generator(pixel_values.device).manual_seed(fold_in(base, 0))
            seed = fold_in(base, 1)
        with span("msvit.forward"):
            out = self.backbone(self.embeddings(pixel_values, generator=g_emb), rng=rng,
                                seed=seed, **output_kwargs)
        if self.add_pooling_layer:
            out["cluster_tokens"] = out["last_cluster_tokens"][:, :, 0, :]
            out["receiver_to_transmitter_attentions"] = out[
                "last_receiver_to_transmitter_attentions"]
        return out


def _lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.lstsq(a, b)[0]` for a [B, m, n], b [B, m, k]: the
    minimum-norm least-squares solution through an SVD, singular values
    below eps * max(m, n) * s_max dropped (the design matrices here are
    rank-deficient; CUDA's `torch.linalg.lstsq` has only `gels`, which
    assumes full rank)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape[-2:])
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vt.mT @ (s_inv[..., None] * (u.mT @ b))


def compress_tokens_with_cluster_indices(
    query_layer: torch.Tensor,  # [B, H, N, dh]
    key_weight: torch.Tensor,  # [D, H, dh]: the K slice of the fused QKV
    key_bias: torch.Tensor,  # [H, dh]
    attention_probs: torch.Tensor,  # [B, H, N, N]
    cluster_indices: torch.Tensor,  # [B, N]
    n_clusters: int,
    head_dim: int,
) -> torch.Tensor:
    """Least-squares "transmitter token" compression (the JAX package's
    function of that name; no forward calls it): C tokens t_c, plus a bias
    absorber per (head, query), whose key projections reproduce the
    cluster-summed attention logits, Q.(W_k t_c + b_k) ~ s.  The design
    matrix, rows (h, q, c), is block-diagonal in c for the tokens and the
    identity in (h, q) for the absorbers: [B, HNC, CD + HN], solved per
    image for the minimum-norm solution (`_lstsq_min_norm`).  Returns
    transmitter_tokens [B, C, D] f32."""
    b, h, n, _ = query_layer.shape
    d = key_weight.shape[0]
    c = n_clusters
    dev = query_layer.device
    masks = (cluster_indices[..., None] == torch.arange(c, device=dev)).to(attention_probs.dtype)
    tx_probs = torch.einsum("bhqk,bkc->bhqc", attention_probs, masks)
    s = multiclass_logits(tx_probs) * head_dim**0.5  # [B, H, N, C]
    qmk = torch.einsum("bhqe,dhe->bhqd", query_layer, key_weight)  # [B, H, N, D]
    s = s - torch.einsum("bhqe,he->bhq", query_layer, key_bias)[..., None]
    xh = torch.einsum("bhqd,ce->bhqced", qmk, torch.eye(c, device=dev)).reshape(b, h * n * c, c * d)
    xc = torch.eye(h * n, device=dev).repeat_interleave(c, dim=0).expand(b, -1, -1)
    w = _lstsq_min_norm(torch.cat([xh, xc], dim=-1), s.reshape(b, h * n * c, 1))
    return w[:, : c * d, 0].reshape(b, c, d)


class MultiStateViTForImageClassification(nn.Module):
    """Classification head over the pooled transmitter tokens (counterpart
    of the JAX package's class): the occupancy-weighted mean of the TX
    tokens (only clusters that own tokens count; the count floored at 1)
    -> an f32 linear `classifier`; mean cross-entropy when `labels` are
    given.  State-dict keys under ``encoder.`` and ``classifier.``.

    Weights are drawn on the CPU from `generator` (seed 0 when None), the
    encoder's first, then moved to `device`."""

    def __init__(
        self,
        config: MultiStateViTConfig,
        num_labels: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.encoder = MultiStateViTEncoderModel(config, True, generator=generator)
        self.classifier = Linear(config.hidden_size, num_labels, True, config, generator)
        self.classifier.compute_dtype = torch.float32  # flax Dense(dtype=float32)
        if device is not None:
            self.to(device)

    def forward(self, pixel_values: torch.Tensor,
                labels: Optional[torch.Tensor] = None, rng=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """The encoder's outputs plus `logits` [B, num_labels] f32 and `loss`
        (None without labels).  `rng` and `generator` as the encoder's."""
        out = self.encoder(pixel_values, rng=rng, generator=generator)
        tx = out["cluster_tokens"].float()  # [B, C, D]
        c = tx.shape[1]
        occ = (F.one_hot(out["last_cluster_indices"], c).sum(1) > 0).float()  # [B, C]
        pooled = (tx * occ[..., None]).sum(1) / occ.sum(1, keepdim=True).clamp_min(1.0)
        logits = self.classifier(pooled)
        loss = None if labels is None else F.cross_entropy(logits, labels)
        out.update(logits=logits, loss=loss)
        return out
