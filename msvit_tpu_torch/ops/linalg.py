"""Small linear-algebra helpers (counterpart of `msvit_tpu/ops/linalg.py`)."""

from __future__ import annotations

from typing import Tuple

import torch

from msvit_tpu_torch.utils.profiling import span


def pca_lowrank(x: torch.Tensor, q: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centered rank-q PCA of x [..., n, d] in f32: (U [..., n, q], S [..., q],
    V [..., d, q]) with x_centered ~ U diag(S) V^T (the `torch.pca_lowrank`
    contract), from `eigh` of the smaller Gram matrix (d x d, or n x n when
    n < d), as the JAX package computes it; leading dims are independent
    matrices.  Each column's sign is the eigensolver's: LAPACK behind
    `torch.linalg.eigh` and behind `jnp.linalg.eigh` may pick opposite
    ones."""
    x = x.float()
    xc = x - x.mean(-2, keepdim=True)
    n, d = xc.shape[-2:]
    if d <= n:
        with span("sync.eigh"):  # the host reads eigh's error code
            w, v = torch.linalg.eigh(xc.mT @ xc)  # ascending
        v = v.flip(-1)[..., :q]
        s = w.flip(-1)[..., :q].clamp_min(0.0).sqrt()
        u = (xc @ v) / s.clamp_min(1e-8)[..., None, :]
    else:
        with span("sync.eigh"):
            w, u_full = torch.linalg.eigh(xc @ xc.mT)
        u = u_full.flip(-1)[..., :q]
        s = w.flip(-1)[..., :q].clamp_min(0.0).sqrt()
        v = (xc.mT @ u) / s.clamp_min(1e-8)[..., None, :]
    return u, s, v
