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
takes `ncut_shared` (one Nystrom anchor pool shared across parents).  The
FPS and axis-align variants raise `NotImplementedError` when a model is
built (`check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from msvit_tpu_torch.ops.kmeans import kmeans
from msvit_tpu_torch.ops.ncut import ncut, ncut_shared

_ROADMAP = "ROADMAP.md queue 1, item 5 (multistate: FPS, axis-align)"


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
    """Raise `NotImplementedError` for a clustering this port cannot run."""
    if config.model_type != "spectral":
        raise NotImplementedError(
            f"clustering model_type={config.model_type!r} is not ported yet "
            f"({_ROADMAP})")


def _ncut_matmul_dtype(config: ClusteringConfig) -> str:
    """Explicit config wins; otherwise f32 for the exact `eigh` path and
    bf16 for `subspace`, as in the JAX package."""
    if config.matmul_dtype:
        return config.matmul_dtype
    return "float32" if config.eig_method == "eigh" else "bfloat16"


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

    # children = #(eigenvalues above threshold), clamped to >= 1 and to the
    # slots still free, in parent order (JAX's `lax.scan`: a loop over
    # device scalars); empty parent slots get 0 children
    k_raw = (vals > config.eigenvalue_threshold).sum(-1)
    cum = torch.zeros((), dtype=torch.long, device=dev)
    n_children, cums = [], []
    for p in range(c_bound):
        k_p = torch.where(has[p], torch.minimum(
            k_raw[p].clamp_min(1), (c_max - cum).clamp_min(1)), 0)
        cums.append(cum)
        n_children.append(k_p)
        cum = cum + k_p
    n_children, cums = torch.stack(n_children), torch.stack(cums)

    # KMeans on the top-k_p eigenvectors: inactive columns zeroed,
    # inactive centers masked
    col_active = torch.arange(config.ncut_dim, device=dev)[None, :] < n_children[:, None]
    labels, _ = kmeans(vecs * col_active[:, None, :], k=config.ncut_dim, key=k_km,
                       iters=config.kmeans_iters, active=col_active, mask=member)

    # parents partition the tokens, so a masked sum assembles global ids
    result = torch.where(member, cums[:, None] + labels, 0).sum(0)
    n_children = torch.nn.functional.pad(n_children, (0, c_max - c_bound))
    return result.clamp(0, c_max - 1), n_children


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
            for pi, xi, ki in zip(parent_indices, x, key.split(b))]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


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
    """Dispatch by `config.model_type` (the spectral variant only)."""
    check_supported(config)
    return spectral_cluster(config, parent_indices, x, key, max_parents=max_parents)
