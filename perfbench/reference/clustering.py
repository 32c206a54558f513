"""Plain spectral token clustering, the reference for the multistate cells.

The batch-pooled spectral variant only (NCut with an RBF affinity and
randomized subspace iteration, the eigenvalue threshold, then KMeans on
the top eigenvectors), written from the multistate encoder's description
and drawing its random numbers as the program does (`rng.py`), so that
the same seed gives the same partition wherever the features agree.  One
token set of B * N tokens; per parent cluster, a member mask.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference.rng import Stream, normal, uniform, words_of


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest, the lower index first among equals."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _gumbel_top_k(streams, member: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct members per row of member [C, n] (Gumbel top-k)."""
    u = uniform(words_of(streams, member.device), (member.shape[-1],), 1e-9, 1.0,
                member.device)
    g = -torch.log(-torch.log(u))
    return _top_k(torch.where(member, g, -torch.inf), k)


def _cross(a: torch.Tensor, b: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":  # the inputs rounded, the products exact in f32
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return a @ b.mT


def _affinity(a: torch.Tensor, b: torch.Tensor, gamma: float, dtype: str) -> torch.Tensor:
    """exp(-d / gamma), d the squared distance over its mean."""
    sq = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * _cross(a, b, dtype)).clamp_min(0.0)
    return torch.exp(-(sq / (sq.mean(dim=(-2, -1), keepdim=True) + 1e-8)) / gamma)


def _top_eig(m_norm: torch.Tensor, k: int, streams, iters: int):
    """Top-k eigenpairs of m_norm [C, m, m] by subspace iteration."""
    m = m_norm.shape[-1]
    k2 = min(2 * k, m)
    dev = m_norm.device
    q = normal(words_of(streams, dev), (m, k2), dev)
    jitter = 1e-7 * torch.eye(k2, device=dev)

    def ortho(y):
        for _ in range(2):
            c, _ = torch.linalg.cholesky_ex(y.mT @ y + jitter)
            y = torch.linalg.solve_triangular(c.mT, y, upper=True, left=False)
        return y

    q = ortho(q)
    for _ in range(iters):
        q = ortho(m_norm @ q)
    h = q.mT @ (m_norm @ q)
    vals, vecs = torch.linalg.eigh((h + h.mT) / 2.0)
    return q @ vecs.flip(-1)[..., :k], vals.flip(-1)[..., :k]


def _ncut(x, member, streams, num_eig, num_sample, gamma, iters, dtype):
    """Per parent: eigenvectors [C, n, e] and eigenvalues [C, e]."""
    m = min(num_sample, x.shape[0])
    idx = _gumbel_top_k(streams, member, m)  # [C, m]
    valid = torch.gather(member, -1, idx)
    xs = x[idx]  # [C, m, d]
    a_ss = _affinity(xs, xs, gamma, dtype)
    a_ss = torch.where(valid[..., :, None] & valid[..., None, :], a_ss, 0.0)
    d_s = a_ss.sum(-1)
    d_inv = torch.where(d_s > 0, torch.rsqrt(d_s + 1e-8), 0.0)
    m_norm = a_ss * d_inv[..., :, None] * d_inv[..., None, :]
    v, vals = _top_eig(m_norm, num_eig, [s.split(2)[1] for s in streams], iters)
    a_nm = _affinity(x[None], xs, gamma, dtype)  # [C, n, m]
    a_nm = torch.where(member[..., :, None] & valid[..., None, :], a_nm, 0.0)
    d_n = a_nm.sum(-1)
    dn_inv = torch.where(d_n > 0, torch.rsqrt(d_n + 1e-8), 0.0)
    lam_inv = torch.where(vals.abs() > 1e-6, 1.0 / vals, 0.0)
    f = (a_nm * dn_inv[..., :, None]) @ (v * (d_inv[..., :, None] * lam_inv[..., None, :]))
    return f / (torch.linalg.vector_norm(f, dim=-2, keepdim=True) + 1e-8), vals


def _kmeans(x, k, streams, iters, active, member):
    """Lloyd's loop on x [C, n, d] over the active centers of each row."""
    centers = torch.gather(x, 1, _gumbel_top_k(streams, member, k)[..., None]
                           .expand(-1, -1, x.shape[-1]))
    x_sq = (x * x).sum(-1)[..., None]
    inactive = ~active[..., None, :]
    ids = torch.arange(k, device=x.device)

    def assign(c):
        d2 = x_sq - 2.0 * (x @ c.mT) + (c * c).sum(-1)[..., None, :]
        return d2.masked_fill(inactive, torch.inf).argmin(-1)

    for _ in range(iters):
        onehot = (assign(centers)[..., None] == ids).float() * member[..., None]
        counts = onehot.sum(-2)
        new = (onehot.mT @ x) / counts.clamp_min(1.0)[..., None]
        centers = torch.where((counts > 0)[..., None], new, centers)
    return assign(centers)


def spectral_cluster(cfg: Dict, parents: torch.Tensor, x: torch.Tensor, stream: Stream,
                     max_parents: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Children of every parent cluster over the whole batch: parents
    [B, N], x [B, N, D] -> (child ids [B, N], children per parent [C])."""
    c_max, e = cfg["max_clusters"], cfg["ncut_dim"]
    c_bound = max(1, min(max_parents, c_max))
    shape = parents.shape
    parents = parents.reshape(-1)
    x = x.reshape(parents.shape[0], -1).float()
    dev = x.device
    member = parents[None, :] == torch.arange(c_bound, device=dev)[:, None]  # [Cb, n]
    has = member.any(-1)
    split = stream.split(2 * c_max)
    k_ncut, k_km = split[:c_bound], split[c_max:c_max + c_bound]
    num_sample = cfg["num_sample"]
    if c_bound > 1 and cfg["late_num_sample"]:
        num_sample = cfg["late_num_sample"]
    vecs, vals = _ncut(x, member, k_ncut, e, num_sample, cfg["affinity_focal_gamma"],
                       cfg["eig_iters"], cfg["matmul_dtype"])
    wish = torch.where(has, (vals > cfg["eigenvalue_threshold"]).sum(-1).clamp_min(1), 0)
    n_children = torch.where(
        has, torch.minimum(wish, c_max - (wish.cumsum(-1) - wish)).clamp_min(1), 0)
    before = n_children.cumsum(-1) - n_children
    col_active = torch.arange(e, device=dev) < n_children[..., None]
    labels = _kmeans(vecs * col_active[..., None, :], e, k_km, cfg["kmeans_iters"],
                     col_active, member)
    child = torch.where(member, before[..., None] + labels, 0).sum(0)
    n_children = torch.nn.functional.pad(n_children, (0, c_max - c_bound))
    return child.clamp(0, c_max - 1).reshape(shape), n_children
