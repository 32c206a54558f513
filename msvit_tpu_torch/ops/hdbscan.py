"""HDBSCAN, the debug clustering of the spectral paths (counterpart of
`msvit_tpu/ops/hdbscan.py`).

The O(n^2) half runs in torch on the tensor's device
(`mutual_reachability_mst`): pairwise distances by one Gram product, core
distances (the `min_samples`-th nearest neighbour, the point itself
included), and a dense Prim over the mutual-reachability graph, n - 1
steps of length-n argmin / minimum with no host sync.  The condensed tree
and the excess-of-mass selection are a sequential pass over the n - 1
edges: host numpy (`labels_from_mst`, the port's own copy of the JAX
package's).  Semantics are `sklearn.cluster.HDBSCAN`'s: mutual reachability
max(core_p, core_q, d_pq), single linkage over the MST, condensed tree at
`min_cluster_size`, excess of mass (no single-cluster allowance), labels
in condensed-tree cluster order.  A debug and analysis facility: nothing
on a forward path calls it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from msvit_tpu_torch.ops.linalg import pca_lowrank


def mutual_reachability_mst(
    x: torch.Tensor,  # [n, d]
    min_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimum spanning tree of the mutual-reachability graph: (src [n-1],
    dst [n-1], weight [n-1]), the edges in the order dense Prim finds them
    (not sorted by weight), on `x`'s device."""
    n = x.shape[0]
    x = x.float()
    sq = (x * x).sum(-1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0).sqrt()
    d.fill_diagonal_(0.0)
    # the k-th smallest of a row, the point's own 0 included (sklearn's rule)
    core = torch.kthvalue(d, min_samples, dim=-1).values
    mr = torch.maximum(d, torch.maximum(core[:, None], core[None, :]))
    mr.fill_diagonal_(float("inf"))

    inf = torch.tensor(float("inf"), device=x.device)
    min_d = mr[0].clone()
    min_src = torch.zeros(n, dtype=torch.long, device=x.device)
    in_tree = torch.zeros(n, dtype=torch.bool, device=x.device)
    in_tree[0] = True
    src = torch.empty(n - 1, dtype=torch.long, device=x.device)
    dst = torch.empty_like(src)
    w = torch.empty(n - 1, device=x.device)
    for i in range(n - 1):
        v = torch.where(in_tree, inf, min_d).argmin()  # the first minimum, as jnp
        src[i], dst[i], w[i] = min_src[v], v, min_d[v]
        in_tree[v] = True
        row = mr[v]
        upd = row < min_d
        min_d = torch.where(upd, row, min_d)
        min_src = torch.where(upd, v, min_src)
    return src, dst, w


class HDBSCANResult(NamedTuple):
    labels: np.ndarray  # [n] int, -1 = noise
    probabilities: np.ndarray  # [n] float in [0, 1]


def _single_linkage(src, dst, weight, n):
    """Dendrogram from MST edges (merge i creates node n+i): returns
    (children [n-1,2], dist [n-1], size [2n-1])."""
    order = np.argsort(weight, kind="stable")
    uf_parent = np.arange(n)

    def find(a):
        root = a
        while uf_parent[root] != root:
            root = uf_parent[root]
        while uf_parent[a] != root:  # path compression
            uf_parent[a], a = root, uf_parent[a]
        return root

    node_of = np.arange(n)  # union-find root -> dendrogram node id
    left = np.empty(n - 1, np.int64)
    right = np.empty(n - 1, np.int64)
    dist = np.empty(n - 1, np.float64)
    size = np.ones(2 * n - 1, np.int64)
    for i, e in enumerate(order):
        ra, rb = find(src[e]), find(dst[e])
        node = n + i
        left[i], right[i] = node_of[ra], node_of[rb]
        dist[i] = weight[e]
        size[node] = size[node_of[ra]] + size[node_of[rb]]
        uf_parent[rb] = ra
        node_of[ra] = node
    return np.stack([left, right], axis=1), dist, size


def _condense(children, dist, size, n, min_cluster_size):
    """Condensed tree (ids: points 0..n-1, root cluster = n): walk the
    dendrogram top-down; a split where both sides have ≥ min_cluster_size
    points creates two new clusters, otherwise the small side's points
    fall out of the current cluster at that node's lambda = 1/distance."""
    c_parent, c_child, c_lambda, c_size = [], [], [], []

    def leaves(node):
        out, stack = [], [node]
        while stack:
            v = stack.pop()
            if v < n:
                out.append(v)
            else:
                stack.extend(children[v - n])
        return out

    def lam(d):
        return 1.0 / d if d > 0.0 else np.inf

    relabel = {2 * n - 2: n}
    next_label = n + 1
    stack = [2 * n - 2]  # parents processed before children
    while stack:
        node = stack.pop()
        cl = relabel[node]
        l, r = children[node - n]
        lv = lam(dist[node - n])
        lsz = size[l] if l >= n else 1
        rsz = size[r] if r >= n else 1
        big = [(c, sz) for c, sz in ((l, lsz), (r, rsz)) if sz >= min_cluster_size]
        small = [(c, sz) for c, sz in ((l, lsz), (r, rsz)) if sz < min_cluster_size]
        if len(big) == 2:  # true split: both children become new clusters
            for c, sz in big:
                relabel[c] = next_label
                c_parent.append(cl)
                c_child.append(next_label)
                c_lambda.append(lv)
                c_size.append(sz)
                next_label += 1
                if c >= n:
                    stack.append(c)
        else:
            for c, _ in small:  # small side's points fall out of cl at lv
                for p in leaves(c):
                    c_parent.append(cl)
                    c_child.append(p)
                    c_lambda.append(lv)
                    c_size.append(1)
            for c, _ in big:  # big side continues as the same cluster
                if c >= n:
                    relabel[c] = cl
                    stack.append(c)
                else:  # a bare point can be >= mcs only if mcs <= 1
                    c_parent.append(cl)
                    c_child.append(c)
                    c_lambda.append(lv)
                    c_size.append(1)

    return (
        np.asarray(c_parent, np.int64),
        np.asarray(c_child, np.int64),
        np.asarray(c_lambda, np.float64),
        np.asarray(c_size, np.int64),
    )


def labels_from_mst(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    n: int,
    min_cluster_size: int,
) -> HDBSCANResult:
    """Host-side HDBSCAN tail: single linkage → condensed tree →
    stability → excess-of-mass selection → labels + probabilities."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float64)

    children, dist, size = _single_linkage(src, dst, weight, n)

    c_parent, c_child, c_lambda, c_size = _condense(
        children, dist, size, n, min_cluster_size
    )
    next_label = int(c_parent.max(initial=n)) + 1 if len(c_parent) else n + 1
    next_label = max(next_label, int(c_child.max(initial=n - 1)) + 1)

    # --- stability: sum over rows of (lambda - birth[parent]) * size ---
    births = {n: 0.0}
    for ch, lv in zip(c_child, c_lambda):
        if ch >= n:
            births[ch] = lv
    stability = {c: 0.0 for c in range(n, next_label)}
    for pa, lv, sz in zip(c_parent, c_lambda, c_size):
        contrib = (lv - births[pa]) * sz
        if np.isfinite(contrib):
            stability[pa] += contrib

    cluster_rows = c_child >= n
    kids = {}  # cluster -> list of child clusters
    for pa, ch in zip(c_parent[cluster_rows], c_child[cluster_rows]):
        kids.setdefault(pa, []).append(ch)

    # --- excess-of-mass selection (root n never selected) ---
    selected = {c: True for c in range(n + 1, next_label)}
    for node in sorted(selected, reverse=True):
        sub = sum(stability[c] for c in kids.get(node, []))
        if sub > stability[node]:
            selected[node] = False
            stability[node] = sub
        else:
            stack = list(kids.get(node, []))
            while stack:
                c = stack.pop()
                selected[c] = False
                stack.extend(kids.get(c, []))

    chosen = sorted(c for c, s in selected.items() if s)
    label_of = {c: i for i, c in enumerate(chosen)}
    cluster_parent = {ch: pa for pa, ch in zip(c_parent[cluster_rows], c_child[cluster_rows])}

    # per-cluster max lambda over its direct rows (for probabilities)
    max_lambda = {}
    for pa, lv in zip(c_parent, c_lambda):
        if np.isfinite(lv):
            max_lambda[pa] = max(max_lambda.get(pa, 0.0), lv)

    labels = np.full(n, -1, np.int64)
    probabilities = np.zeros(n, np.float64)
    point_rows = ~cluster_rows
    for pa, p, lv in zip(c_parent[point_rows], c_child[point_rows], c_lambda[point_rows]):
        c = pa
        while c != n and not selected.get(c, False):
            c = cluster_parent[c]
        if c == n:
            continue
        labels[p] = label_of[c]
        ml = max_lambda.get(c, 0.0)
        probabilities[p] = 1.0 if (ml <= 0.0 or not np.isfinite(lv)) else min(lv, ml) / ml
    return HDBSCANResult(labels, probabilities)


def hdbscan(
    x,  # [n, d] tensor or array
    min_cluster_size: int,
    min_samples: Optional[int] = None,
) -> HDBSCANResult:
    """Full HDBSCAN: the MST on `x`'s device, the extraction on the host.
    `min_samples` defaults to `min_cluster_size` (sklearn's default)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    ms = min(min_cluster_size if min_samples is None else min_samples, n)
    src, dst, w = mutual_reachability_mst(x, min_samples=ms)
    return labels_from_mst(src.cpu().numpy(), dst.cpu().numpy(), w.cpu().numpy(), n,
                           min_cluster_size)


def hdbncut_sample_indices(
    features,  # [n, d]
    num_sample: int,
    key,  # an Rng
    cluster_size_threshold: float = 0.01,
    min_samples: int = 512,
    pca_dim: int = 8,
) -> np.ndarray:
    """HDBNCUT's Nystrom-anchor filter: PCA to `pca_dim`, HDBSCAN labels,
    up to `num_sample` anchor indices drawn uniformly from the clustered
    (non-noise) points (all points when every one is noise).  A host numpy
    index array, for `ncut`'s anchors.  The draw's order is the argsort of
    `key.uniform` over the clustered points; `jax.random.permutation`
    draws another order from its key, so the two packages agree on the
    clustered set and not on which of them are taken."""
    features = torch.as_tensor(features)
    n = features.shape[0]
    u, s, _ = pca_lowrank(features, q=pca_dim)
    labels, _ = hdbscan(u * s[None, :], min_cluster_size=max(int(cluster_size_threshold * n), 2),
                        min_samples=min(min_samples, n))
    clustered = np.where(labels != -1)[0]
    if clustered.size == 0:  # degenerate: everything is noise
        clustered = np.arange(n)
    perm = torch.argsort(key.uniform((clustered.size,), 0.0, 1.0, "cpu")).numpy()
    return clustered[perm[:num_sample]]
