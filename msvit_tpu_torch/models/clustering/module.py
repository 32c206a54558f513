"""Token clustering (counterpart of `msvit_tpu/models/clustering/module.py`).

The spectral variant, the production path: per parent cluster, NCut-embed
the member tokens, count children by thresholding the eigenvalues, KMeans
the top eigenvectors.  As in the JAX package every per-parent stage is
batched over a padded parent axis with member masks, and the child count
becomes an active-center mask in KMeans.  Child counts, cluster counts and
ids stay tensors on the device: no host sync, no data-dependent shape.

Randomness: the functions take an `Rng` (utils/rng.py) wherever the JAX
package takes a key and split it in JAX's order, so a stream that draws
JAX's numbers reproduces JAX's partition.

The config classes are ported field for field.  `shared_anchors=True`
takes `ncut_shared` (one Nystrom anchor pool shared across parents).

The FPS variant (`fps_cluster`): NCut-embed all tokens, PCA, blocked FPS of
`fps_sample1` candidates, their cosine-similarity profiles standardised
and PCA-ed, blocked FPS of `fps_supersample2` of them, the `fps_sample2`
that most tokens resemble become centers, each token takes its most
similar center.  The axis-align variant (`axis_align_cluster`): the
Gumbel-perturbed argmax over the NCut axes of the demeaned tokens.  Both
cluster globally (parents are ignored, then each child is credited to the
parent holding most of its tokens); per image (`pool_batch=False`) they run
the pooled function on one image at a time, image i on `key.split(B)[i]`.
Their outputs depend on the eigensolver's column signs (the PCA's sort
axis, the NCut axes), which LAPACK may pick otherwise than JAX's solver.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from msvit_tpu_torch.ops.fps import farthest_point_sampling_blocked
from msvit_tpu_torch.ops.kmeans import kmeans, top_k_indices
from msvit_tpu_torch.ops.linalg import pca_lowrank
from msvit_tpu_torch.ops.ncut import ncut, ncut_shared


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    model_type: str = ""
    ncut_dim: int = 8
    num_sample: int = 1024
    # static upper bound on total clusters (the padded cluster axis)
    max_clusters: int = 16
    # True: tokens of every image are pooled per parent cluster (cluster
    # ids are global across the batch); False: each image alone
    pool_batch: bool = True


@dataclasses.dataclass(frozen=True)
class SpectralClusteringConfig(ClusteringConfig):
    model_type: str = "spectral"
    ncut_dist: str = "rbf"  # "rbf" | "cosine"
    eigenvalue_threshold: float = 0.1
    cluster_size_threshold: float = 0.0  # kept for config parity (unused)
    affinity_focal_gamma: float = 3.0
    kmeans_iters: int = 16
    eig_method: str = "subspace"  # "subspace" | "eigh"
    eig_iters: int = 12
    # affinity product dtype; "" = float32 for "eigh", bfloat16 otherwise
    matmul_dtype: str = ""
    shared_anchors: bool = False  # one anchor pool for all parents
    anchors_per_parent: int = 256
    # per-parent sample budget of calls that can see more than one parent
    # (0 = num_sample everywhere)
    late_num_sample: int = 0


@dataclasses.dataclass(frozen=True)
class FPSClusteringConfig(ClusteringConfig):
    model_type: str = "fps"
    fps_dim: int = 8
    fps_sample1: int = 64
    fps_sample2: int = 8
    fps_supersample2: int = 32
    cosine_similarity_threshold: float = 0.7
    ncut_dist: str = "cosine"
    affinity_focal_gamma: float = 3.0
    eig_method: str = "subspace"
    eig_iters: int = 12
    matmul_dtype: str = ""


@dataclasses.dataclass(frozen=True)
class AxisAlignClusteringConfig(ClusteringConfig):
    model_type: str = "axis"
    temperature: float = 1.0
    ncut_dist: str = "cosine"
    affinity_focal_gamma: float = 3.0


def check_supported(config: ClusteringConfig) -> None:
    """Raise `ValueError` for a `model_type` with no clustering."""
    if config.model_type not in CLUSTERING_CLASSES:
        raise ValueError(f"clustering model_type={config.model_type!r}: one of "
                         f"{sorted(CLUSTERING_CLASSES)}")


def _ncut_matmul_dtype(config: ClusteringConfig) -> str:
    """Explicit config wins; otherwise f32 for the exact `eigh` path and
    bf16 for `subspace`, as in the JAX package."""
    if config.matmul_dtype:
        return config.matmul_dtype
    return "float32" if config.eig_method == "eigh" else "bfloat16"


def child_counts(has: torch.Tensor, k_raw: torch.Tensor,
                 c_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Children per parent slot and the slots taken before each: k_raw
    (the eigenvalues above the threshold) clamped to >= 1 and to the slots
    still free, in parent order; empty parent slots (`has` false) get 0.
    JAX's `lax.scan` over the parents in closed form: a parent's share is
    taken against the prefix sum of the wishes before it, which is the
    scan's running sum up to the first parent that overflows the slots;
    every parent after that gets the floor of 1 in both.  Returns
    (n_children [C], exclusive prefix sums [C])."""
    wish = torch.where(has, k_raw.clamp_min(1), 0)
    n_children = torch.where(
        has, torch.minimum(wish, c_max - (wish.cumsum(0) - wish)).clamp_min(1), 0)
    return n_children, n_children.cumsum(0) - n_children


def _spectral_single(
    config: SpectralClusteringConfig,
    flat_parent: torch.Tensor,  # [M] int
    flat_x: torch.Tensor,  # [M, D]
    key,
    max_parents: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-parent NCut -> threshold -> KMeans over one token set; returns
    (child ids [M] int64, n_children [C_max] int64).  `max_parents` is a
    static bound on the distinct parent ids present (exact: the per-parent
    streams are sliced from the same `2 * C_max` split)."""
    c_max = config.max_clusters
    c_bound = c_max if max_parents is None else max(1, min(max_parents, c_max))
    flat_x = flat_x.float()
    dev = flat_x.device

    member = flat_parent[None, :] == torch.arange(c_bound, device=dev)[:, None]
    has = member.any(1)  # [Cb]
    keys = key.split(2 * c_max)
    k_ncut, k_km = keys[:c_bound], keys[c_max:c_max + c_bound]

    num_sample = config.num_sample
    if c_bound > 1 and config.late_num_sample:
        num_sample = config.late_num_sample

    common = dict(num_eig=config.ncut_dim, num_sample=num_sample,
                  distance=config.ncut_dist, gamma=config.affinity_focal_gamma,
                  eig_method=config.eig_method, eig_iters=config.eig_iters,
                  matmul_dtype=_ncut_matmul_dtype(config))
    if config.shared_anchors:
        vecs, vals = ncut_shared(flat_x, key=k_ncut[0], member=member,
                                 anchors_per_parent=config.anchors_per_parent,
                                 **common)
    else:
        vecs, vals = ncut(flat_x, key=k_ncut, mask=member, **common)
    # [Cb, M, e], [Cb, e]

    n_children, cums = child_counts(has, (vals > config.eigenvalue_threshold).sum(-1), c_max)

    # KMeans on the top-k_p eigenvectors: inactive columns zeroed,
    # inactive centers masked
    col_active = torch.arange(config.ncut_dim, device=dev)[None, :] < n_children[:, None]
    labels, _ = kmeans(vecs * col_active[:, None, :], k=config.ncut_dim, key=k_km,
                       iters=config.kmeans_iters, active=col_active, mask=member)

    # parents partition the tokens, so a masked sum assembles global ids
    result = torch.where(member, cums[:, None] + labels, 0).sum(0)
    n_children = torch.nn.functional.pad(n_children, (0, c_max - c_bound))
    return result.clamp(0, c_max - 1), n_children


def _per_image_batch(b) -> int:
    """The batch size of a per-image (`pool_batch=False`) call, which loops
    over the images in Python: a symbolic one (an export with a symbolic
    batch) raises."""
    if isinstance(b, torch.SymInt):
        raise ValueError(
            "per-image clustering (pool_batch=False) loops over the batch in Python and "
            "exports at a fixed batch only: export with polymorphic_batch=False, or "
            "cluster with pool_batch=True")
    return b


def spectral_cluster(
    config: SpectralClusteringConfig,
    parent_indices: torch.Tensor,  # [B, N] int
    x: torch.Tensor,  # [B, N, D]
    key,
    max_parents: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (child_indices [B, N], n_children): [C_max] in pooled mode
    (ids global across the batch), [B, C_max] per image
    (`pool_batch=False`, image i draws from `key.split(B)[i]`)."""
    b, n = parent_indices.shape
    if config.pool_batch:
        result, n_children = _spectral_single(
            config, parent_indices.reshape(b * n), x.reshape(b * n, -1), key,
            max_parents=max_parents)
        return result.reshape(b, n), n_children
    outs = [_spectral_single(config, pi, xi, ki, max_parents=max_parents)
            for pi, xi, ki in zip(parent_indices, x, key.split(_per_image_batch(b)))]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _parent_majority(child_indices: torch.Tensor, parent_indices: torch.Tensor,
                     c_max: int) -> torch.Tensor:
    """n_children [C_max] for the variants that ignore parents: each
    occupied child cluster is credited to the parent owning most of its
    tokens (the lower id among equals)."""
    ids = torch.arange(c_max, device=child_indices.device)

    def one_hot(i):  # an id >= c_max gives a zero row, as jax.nn.one_hot
        return (i.reshape(-1, 1) == ids).float()

    child_oh = one_hot(child_indices)  # [BN, C]
    votes = child_oh.T @ one_hot(parent_indices)  # [C_child, C_parent]
    occupied = (child_oh.sum(0) > 0).float()
    return (one_hot(votes.argmax(-1)).T @ occupied).long()


def _per_image(fn, config, parent_indices, x, key):
    """Per-image mode of a variant written against pooled flat tokens: the
    pooled function on each image alone, image i on `key.split(B)[i]`."""
    pooled = dataclasses.replace(config, pool_batch=True)
    b = _per_image_batch(parent_indices.shape[0])
    outs = [fn(pooled, pi[None], xi[None], ki)
            for pi, xi, ki in zip(parent_indices, x, key.split(b))]
    return torch.cat([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)


def fps_cluster(
    config: FPSClusteringConfig,
    parent_indices: torch.Tensor,  # [B, N] int
    x: torch.Tensor,  # [B, N, D]
    key,
    max_parents: Optional[int] = None,  # unused: FPS clusters globally
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FPS variant (module docstring).  Returns (child_indices [B, N],
    n_children [C_max], or [B, C_max] per image)."""
    b, n = parent_indices.shape
    if not config.pool_batch:
        return _per_image(fps_cluster, config, parent_indices, x, key)
    flat_x = x.reshape(b * n, -1).float()
    _, k_ncut, k_f1, k_f2 = key.split(4)
    ncut_x, _ = ncut(flat_x, num_eig=config.ncut_dim, key=k_ncut,
                     num_sample=config.num_sample, distance=config.ncut_dist,
                     gamma=config.affinity_focal_gamma, eig_method=config.eig_method,
                     eig_iters=config.eig_iters, matmul_dtype=_ncut_matmul_dtype(config))
    pca_x, _, _ = pca_lowrank(ncut_x, config.fps_dim)
    s1 = ncut_x[farthest_point_sampling_blocked(pca_x, config.fps_sample1, key=k_f1)]
    sim = _unit(s1) @ _unit(ncut_x).T  # [s1, BN]
    sim_std = (sim - sim.mean(-1, keepdim=True)) / (
        sim.std(-1, keepdim=True, correction=0) + 1e-8)
    s1_pca, _, _ = pca_lowrank(sim_std, config.fps_dim)
    ss2 = s1[farthest_point_sampling_blocked(s1_pca, config.fps_supersample2, key=k_f2)]
    sim2 = _unit(ss2) @ _unit(ncut_x).T  # [ss2, BN]
    score = (sim2 > config.cosine_similarity_threshold).sum(-1)
    centers = top_k_indices(score, config.fps_sample2)
    child = sim2[centers].argmax(0).reshape(b, n)
    return child, _parent_majority(child, parent_indices, config.max_clusters)


def axis_align_cluster(
    config: AxisAlignClusteringConfig,
    parent_indices: torch.Tensor,  # [B, N] int
    x: torch.Tensor,  # [B, N, D]
    key,
    max_parents: Optional[int] = None,  # unused: axis-align is global
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The axis-align variant (module docstring): NCut (its defaults:
    `eigh`, bf16 affinity products) of the demeaned tokens, then
    argmax(ncut_x / temperature + Gumbel noise) over the axes, the noise
    drawn as JAX's `random.gumbel`: -log(-log(uniform(tiny, 1)))."""
    b, n = parent_indices.shape
    if not config.pool_batch:
        return _per_image(axis_align_cluster, config, parent_indices, x, key)
    flat_x = x.reshape(b * n, -1).float()
    _, k_ncut, k_g = key.split(3)
    ncut_x, _ = ncut(flat_x - flat_x.mean(0, keepdim=True), num_eig=config.ncut_dim,
                     key=k_ncut, num_sample=config.num_sample, distance=config.ncut_dist,
                     gamma=config.affinity_focal_gamma)
    u = k_g.uniform(ncut_x.shape, torch.finfo(torch.float32).tiny, 1.0, ncut_x.device)
    child = (ncut_x / config.temperature - torch.log(-torch.log(u))).argmax(-1)
    child = child.reshape(b, n)
    return child, _parent_majority(child, parent_indices, config.max_clusters)


CLUSTERING_CLASSES = {
    "spectral": spectral_cluster,
    "fps": fps_cluster,
    "axis": axis_align_cluster,
}


def max_children_bound(config: ClusteringConfig, max_parents: int) -> int:
    """Static upper bound on the child clusters one call can produce when
    at most `max_parents` distinct parent ids are present."""
    c = config.max_clusters
    if config.model_type == "spectral":
        return min(max_parents * config.ncut_dim, c)
    if config.model_type == "fps":
        return min(config.fps_sample2, c)
    if config.model_type == "axis":
        return min(config.ncut_dim, c)
    return c


def cluster(
    config: ClusteringConfig,
    parent_indices: torch.Tensor,
    x: torch.Tensor,
    key,
    max_parents: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by `config.model_type` (`CLUSTERING_CLASSES`)."""
    check_supported(config)
    return CLUSTERING_CLASSES[config.model_type](
        config, parent_indices, x, key, max_parents=max_parents)


def spectral_debug_labels(
    ncut_x: torch.Tensor,  # [n, ncut_dim] NCut eigenvectors (pooled batch)
    key,  # an Rng
    cluster_size_threshold: float = 0.02,
    min_samples: int = 512,
    num_sample: int = 1024,
    kmeans_iters: int = 16,
):
    """The debug labellings of the spectral clustering (the JAX package's
    `spectral_debug_labels`), from the batch-pooled NCut eigenvectors:

    * ``hdbscan``: HDBSCAN on the cosine NCut of the row-normalised
      eigenvectors; noise is -1;
    * ``km_boosted_spectral``: the nearest HDBSCAN centroid;
    * ``km_spectral``: KMeans started from those centroids;
    * ``aa_boosted_spectral``: the `kway_ncut` rotation fitted on the
      clustered rows, applied to all;
    * ``aa_spectral``: the plain `kway_ncut` one-hot argmax.

    Host-side (the HDBSCAN tree is host code); nothing on a forward path
    calls it.  Returns an ``OrderedDict[str, np.ndarray [n]]``, with
    ``hdbscan`` only when HDBSCAN finds no cluster.  Draws in JAX's order:
    ``k1, k2 = key.split(2)``, the NCut's anchors from k1, KMeans from k2."""
    from collections import OrderedDict

    import numpy as np

    from msvit_tpu_torch.ops.hdbscan import hdbscan
    from msvit_tpu_torch.ops.ncut import kway_ncut

    ncut_x = ncut_x.float()
    n, k_dim = ncut_x.shape
    normalized = ncut_x / (torch.linalg.vector_norm(ncut_x, dim=-1, keepdim=True) + 1e-8)
    k1, k2 = key.split(2)
    spectral_x, _ = ncut(normalized, num_eig=k_dim, key=k1, num_sample=min(num_sample, n),
                         distance="cosine", gamma=3.0)
    res = hdbscan(spectral_x, min_cluster_size=max(int(cluster_size_threshold * n), 2),
                  min_samples=min(min_samples, n))
    labels = np.asarray(res.labels)
    out = OrderedDict(hdbscan=labels)
    n_child = int(labels.max()) + 1
    if n_child == 0:
        return out

    sx = spectral_x[:, :n_child]
    sx_np = sx.cpu().numpy()
    centers = np.stack([sx_np[labels == c].mean(axis=0) for c in range(n_child)])
    d2 = ((sx_np[:, None] - centers[None]) ** 2).sum(-1)  # [n, n_child]
    out["km_boosted_spectral"] = d2.argmin(axis=1)
    km_labels, _ = kmeans(sx, k=n_child, key=k2, iters=kmeans_iters,
                          init_centers=torch.from_numpy(centers).to(sx.device))
    out["km_spectral"] = km_labels.cpu().numpy()

    clustered = labels >= 0
    fit_rows = sx[torch.from_numpy(clustered).to(sx.device)] \
        if clustered.sum() >= n_child else sx
    _, rt = kway_ncut(fit_rows)
    out["aa_boosted_spectral"] = (sx @ rt).argmax(1).cpu().numpy()
    onehot, _ = kway_ncut(sx)
    out["aa_spectral"] = onehot.argmax(1).cpu().numpy()
    return out
