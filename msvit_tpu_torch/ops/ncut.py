"""Nystrom normalized-cuts spectral embedding (counterpart of
`msvit_tpu/ops/ncut.py`).

Subsample members (Gumbel top-k) -> affinity (cosine or rbf, focal gamma)
-> symmetric-normalized affinity -> top eigenpairs (dense `eigh`, or
randomized subspace iteration) -> Nystrom propagation to all points.
Static shapes throughout: membership is a mask, non-members get zero
affinity.  Eigenvalues are those of the normalized affinity, descending.

Batched over parents: a `mask [C, n]` with one random stream per parent
computes what the JAX package's vmap over parents computes, the draws
taken in JAX's order (`uniform` for the sample, then `split(2)[1]` and
`normal` for the subspace start).  `ncut_shared` (`shared_anchors=True`)
draws one anchor pool for all parents and gives each its pool anchors.
`ncut_images` and `ncut_shared_images` run G token sets side by side (the
images of a per-image clustering call, JAX's vmap over images): x [G, n,
d], one stream row per image (utils/rng.py `image_streams`).

bf16 affinity products: JAX rounds the inputs of the [m, n] cross product
to bf16 and accumulates in f32.  A bf16 `torch.matmul` rounds its output
to bf16 as well, so the port rounds the inputs and multiplies in f32:
bf16 x bf16 products are exact in f32.

`kway_ncut` turns an embedding into axis-aligned clusters (the Yu-Shi
discretisation of the JAX package's debug path).

`eigh` syncs the host with the card (PyTorch checks its error code on
the host): at least once per call on the [2k, 2k] Rayleigh-Ritz matrix
with `eig_method="subspace"`; the span `sync.eigh` marks it.  The Cholesky
factorisations use `cholesky_ex`, which does not.  Each batched draw from
`Rng` keys also waits, for the copy of the keys' words to the card
(`utils/rng.py`, `sync.key_words`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from msvit_tpu_torch.ops.kmeans import gather_rows, gumbel_top_k, top_k_indices
from msvit_tpu_torch.utils.profiling import span
from msvit_tpu_torch.utils.rng import KeyRows, normal_rows


def _cross(a: torch.Tensor, b: torch.Tensor, dtype: str) -> torch.Tensor:
    """a @ b^T in f32, the inputs rounded to `dtype` first."""
    if dtype == "bfloat16":
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    elif dtype != "float32":
        raise ValueError(f"matmul_dtype {dtype!r}")
    return a @ b.mT


def _pairwise_affinity(
    a: torch.Tensor,  # [..., m, d]
    b: torch.Tensor,  # [..., n, d]
    distance: str,
    gamma: float,
    matmul_dtype: str = "bfloat16",
) -> torch.Tensor:
    """A = exp(-d / gamma), [..., m, n]: cosine distance, or squared
    euclidean scaled by its mean (per matrix) so gamma is unitless."""
    if distance == "cosine":
        an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
        bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        d = 1.0 - _cross(an, bn, matmul_dtype)
    elif distance == "rbf":
        sq = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
              - 2.0 * _cross(a, b, matmul_dtype))
        sq = sq.clamp_min(0.0)
        d = sq / (sq.mean(dim=(-2, -1), keepdim=True) + 1e-8)
    else:
        raise ValueError(distance)
    return torch.exp(-d / gamma)


def _topk_eig_subspace(
    m_norm: torch.Tensor,  # [(G,) C, m, m] symmetric
    k: int,
    keys: Sequence,
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs by randomized subspace iteration: 2k random
    directions (`normal` from each parent's stream), `iters` power steps
    with CholeskyQR2 re-orthonormalization, then Rayleigh-Ritz on the
    [2k, 2k] projection.  Returns ([..., C, m, k], [..., C, k] descending)
    for m_norm [..., C, m, m]."""
    m = m_norm.shape[-1]
    k2 = torch.sym_min(2 * k, m)
    dev = m_norm.device
    q = normal_rows(keys, (m, k2), dev)
    jitter = 1e-7 * torch.eye(k2, device=dev)

    def ortho(y):
        for _ in range(2):
            c, _ = torch.linalg.cholesky_ex(y.mT @ y + jitter)
            # y <- y c^-T: solves X c^T = y (JAX's triangular_solve with
            # left_side=False, lower=True, transpose_a=True)
            y = torch.linalg.solve_triangular(c.mT, y, upper=True, left=False)
        return y

    q = ortho(q)
    for _ in range(iters):
        q = ortho(m_norm @ q)
    h = q.mT @ (m_norm @ q)
    with span("sync.eigh"):
        vals, vecs = torch.linalg.eigh((h + h.mT) / 2.0)  # ascending
    return q @ vecs.flip(-1)[..., :k], vals.flip(-1)[..., :k]


def _embed(
    x: torch.Tensor,  # [G, n, d]
    xs: torch.Tensor,  # [G, C, m, d] each parent's samples
    sample_valid: torch.Tensor,  # [G, C, m] bool
    member: torch.Tensor,  # [G, C, n] bool
    num_eig: int,
    eig_keys: Sequence,  # one stream row per parent (subspace only)
    distance: str,
    gamma: float,
    eig_method: str,
    eig_iters: int,
    matmul_dtype: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per parent: the samples' normalized affinity, its top eigenpairs and
    their Nystrom extension to all points.  Returns (eigvecs [G, C, n,
    num_eig], eigvals [G, C, num_eig] descending)."""
    a_ss = _pairwise_affinity(xs, xs, distance, gamma, matmul_dtype)
    vmask = sample_valid[..., :, None] & sample_valid[..., None, :]
    a_ss = torch.where(vmask, a_ss, 0.0)
    d_s = a_ss.sum(-1)
    d_inv_sqrt = torch.where(d_s > 0, torch.rsqrt(d_s + 1e-8), 0.0)
    m_norm = a_ss * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]

    if eig_method == "subspace":
        v, eigvals = _topk_eig_subspace(m_norm, num_eig, eig_keys, eig_iters)
    elif eig_method == "eigh":
        with span("sync.eigh"):
            ev, evec = torch.linalg.eigh(m_norm)  # ascending
        eigvals = ev.flip(-1)[..., :num_eig]
        v = evec.flip(-1)[..., :num_eig]
    else:
        raise ValueError(f"eig_method {eig_method!r}")

    # Nystrom extension: f = D_n^-1/2 A_nm D_s^-1/2 V Lambda^-1
    a_nm = _pairwise_affinity(x[:, None], xs, distance, gamma, matmul_dtype)  # [G, C, n, m]
    a_nm = torch.where(member[..., :, None] & sample_valid[..., None, :], a_nm, 0.0)
    d_n = a_nm.sum(-1)
    dn_inv_sqrt = torch.where(d_n > 0, torch.rsqrt(d_n + 1e-8), 0.0)
    lam_inv = torch.where(eigvals.abs() > 1e-6, 1.0 / eigvals, 0.0)
    f = (a_nm * dn_inv_sqrt[..., :, None]) @ (
        v * (d_inv_sqrt[..., :, None] * lam_inv[..., None, :]))
    # column-normalize for a stable embedding scale
    f = f / (torch.linalg.vector_norm(f, dim=-2, keepdim=True) + 1e-8)
    return f, eigvals


def ncut_images(
    x: torch.Tensor,  # [G, n, d]
    num_eig: int,
    keys: Sequence,  # C stream rows (G streams each), one per mask row
    member: torch.Tensor,  # [G, C, n] bool
    num_sample: int = 1024,
    distance: str = "rbf",
    gamma: float = 3.0,
    eig_method: str = "eigh",
    eig_iters: int = 12,
    matmul_dtype: str = "bfloat16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ncut` over G token sets side by side, C parents each.  Returns
    (eigvecs [G, C, n, num_eig], eigvals [G, C, num_eig])."""
    n = x.shape[1]
    x = x.float()
    # under an export with a symbolic batch n is B * N: `min` would branch
    # on B (816 tokens an image against 1024 samples flips at B = 2)
    m = torch.sym_min(num_sample, n)
    member = member.bool()
    sample_idx = gumbel_top_k(keys, member, m)  # [G, C, m]
    sample_valid = torch.gather(member, -1, sample_idx)  # all-masked corner
    k_sub = [kk.split(2)[1] for kk in keys] if eig_method == "subspace" else None
    xs = gather_rows(x[:, None], sample_idx)  # [G, C, m, d]
    return _embed(x, xs, sample_valid, member, num_eig, k_sub, distance, gamma,
                  eig_method, eig_iters, matmul_dtype)


def ncut(
    x: torch.Tensor,  # [n, d]
    num_eig: int,
    key,  # an Rng; a sequence of them (one per mask row) for a [C, n] mask
    num_sample: int = 1024,
    distance: str = "rbf",
    gamma: float = 3.0,
    mask: Optional[torch.Tensor] = None,  # [n] or [C, n] bool
    eig_method: str = "eigh",
    eig_iters: int = 12,
    matmul_dtype: str = "bfloat16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (eigvecs [(C,) n, num_eig] f32, rows of non-members
    arbitrary; eigvals [(C,) num_eig] descending)."""
    batched = isinstance(key, (list, tuple))
    keys = [KeyRows([k]) for k in (key if batched else [key])]
    n = x.shape[0]
    c = len(keys)
    if mask is None:
        member = torch.ones((c, n), dtype=torch.bool, device=x.device)
    else:
        member = mask.bool().reshape(-1, n).expand(c, n)
    f, eigvals = ncut_images(x[None], num_eig, keys, member[None], num_sample, distance,
                             gamma, eig_method, eig_iters, matmul_dtype)
    return (f[0], eigvals[0]) if batched else (f[0, 0], eigvals[0, 0])


def ncut_shared_images(
    x: torch.Tensor,  # [G, n, d]
    num_eig: int,
    key,  # a stream row (G streams)
    member: torch.Tensor,  # [G, C, n] bool
    num_sample: int = 1024,
    anchors_per_parent: int = 256,
    distance: str = "rbf",
    gamma: float = 3.0,
    eig_method: str = "subspace",
    eig_iters: int = 12,
    matmul_dtype: str = "bfloat16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ncut_shared` over G token sets side by side.  Returns (eigvecs
    [G, C, n, num_eig], eigvals [G, C, num_eig])."""
    c, n = member.shape[-2:]
    x = x.float()
    dev = x.device
    m = torch.sym_min(num_sample, n)
    mc = torch.sym_min(anchors_per_parent, m)
    member = member.bool()
    any_member = member.any(-2)  # [G, n]

    k_pool, k_sel = key.split(2)
    g = -torch.log(-torch.log(k_pool.uniform((n,), 1e-9, 1.0, dev)))
    pool_idx = top_k_indices(torch.where(any_member, g, -torch.inf), m)  # [G, m]
    xs = gather_rows(x, pool_idx)  # [G, m, d]
    amem = (torch.gather(member, -1, pool_idx[:, None, :].expand(-1, c, -1))
            & torch.gather(any_member, -1, pool_idx)[:, None, :])  # [G, C, m]
    g2 = -torch.log(-torch.log(k_sel.uniform((c, m), 1e-9, 1.0, dev)))
    sel = top_k_indices(torch.where(amem, g2, -torch.inf), mc)  # [G, C, mc]
    sel_valid = torch.gather(amem, -1, sel)
    return _embed(x, gather_rows(xs[:, None], sel), sel_valid, member, num_eig,
                  key.split(c), distance, gamma, eig_method, eig_iters, matmul_dtype)


def ncut_shared(
    x: torch.Tensor,  # [n, d]
    num_eig: int,
    key,  # an Rng
    member: torch.Tensor,  # [C, n] bool: per-parent token membership
    num_sample: int = 1024,
    anchors_per_parent: int = 256,
    distance: str = "rbf",
    gamma: float = 3.0,
    eig_method: str = "subspace",
    eig_iters: int = 12,
    matmul_dtype: str = "bfloat16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-parent NCut with ONE shared Nystrom anchor pool (the JAX
    package's `shared_anchors` path): `num_sample` anchors drawn by Gumbel
    top-k from the tokens of any parent, then each parent takes the (at
    most `anchors_per_parent`) pool anchors inside it, by a second Gumbel
    top-k; the per-parent eigensolve and extension run on those.  Draws in
    JAX's order: ``k_pool, k_sel = key.split(2)`` (`uniform((n,))` and
    `uniform((C, m))`), then ``key.split(C)`` for the eigensolves.

    Returns (eigvecs [C, n, num_eig], eigvals [C, num_eig] descending)."""
    f, eigvals = ncut_shared_images(x[None], num_eig, KeyRows([key]), member[None],
                                    num_sample, anchors_per_parent, distance, gamma,
                                    eig_method, eig_iters, matmul_dtype)
    return f[0], eigvals[0]


def kway_ncut(
    x: torch.Tensor,  # [n, k] spectral embedding (top-k eigenvectors)
    iters: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiclass spectral discretisation (Yu & Shi 2003), the JAX
    package's `kway_ncut`: rows normalised, a greedy near-orthogonal
    initial basis (the largest-norm row, then each next row of least
    accumulated |cos| to those taken), then `iters` fixed alternations of
    the row-argmax one-hot D and the orthogonal Procrustes rotation
    R = U V^T of svd(X^T D) (k x k).  Returns (onehot [n, k] f32, rotation
    [k, k]); U V^T does not depend on the SVD's signs."""
    n, k = x.shape
    x = x.float()
    xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)
    rows = [xn[torch.linalg.vector_norm(x, dim=1).argmax()]]
    c = torch.zeros(n, device=x.device)
    for _ in range(k - 1):
        c = c + (xn @ rows[-1]).abs()
        rows.append(xn[c.argmin()])
    r = torch.stack(rows, dim=1)  # columns: the basis directions

    def onehot(r):
        return torch.nn.functional.one_hot((xn @ r).argmax(1), k).float()

    for _ in range(iters):
        u, _, vt = torch.linalg.svd(xn.T @ onehot(r), full_matrices=False)
        r = u @ vt
    return onehot(r), r
