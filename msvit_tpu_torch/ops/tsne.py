"""Exact t-SNE on the tensor's device (counterpart of `msvit_tpu/ops/tsne.py`),
for the debug views of the spectral clustering.

Every heavy term is a matrix product: pairwise squared distances by the
Gram trick; the per-row perplexity calibration as a bisection over all
rows at once (a fixed count of iterations of sklearn's doubling / halving
bracket); the KL gradient loop with sklearn's optimizer schedule (early
exaggeration, momentum 0.5 -> 0.8, per-parameter gains, the "auto"
learning rate), for a fixed number of iterations.  Exact mode: O(n^2)
memory, for debug-scale n (a few thousand rows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-12  # sklearn's MACHINE_EPSILON guard on P and Q


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """[n, d] -> [n, n] squared euclidean distances (Gram trick, f32)."""
    x = x.float()
    sq = (x * x).sum(-1)
    return (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)


def conditional_probabilities(
    d2: torch.Tensor,  # [n, n] squared distances
    perplexity: float,
    iters: int = 64,
) -> torch.Tensor:
    """Row-stochastic P(j|i) whose rows have entropy log(perplexity):
    every row keeps (beta, lo, hi) and moves each iteration (doubling or
    halving while unbracketed, else bisecting).  Distances are shifted by
    their row's minimum before the exp (the entropy and the normalised
    probabilities do not change)."""
    n = d2.shape[0]
    target = torch.log(torch.tensor(float(perplexity), dtype=torch.float32))
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2 = torch.where(eye, float("inf"), d2.float())
    shift = d2.amin(1, keepdim=True)
    ds = torch.where(eye, float("inf"), d2 - shift)

    def entropy(beta):  # beta [n, 1] -> (H [n], P [n, n])
        p = torch.exp(-ds * beta)  # the diagonal: exp(-inf) = 0
        sum_p = p.sum(1, keepdim=True).clamp_min(_EPS)
        p = p / sum_p
        h = torch.log(sum_p[:, 0]) + beta[:, 0] * torch.where(eye, 0.0, ds * p).sum(1)
        return h, p

    beta = torch.ones(n, 1, device=d2.device)
    lo = torch.zeros(n, 1, device=d2.device)  # 0: not bracketed below
    hi = torch.full((n, 1), float("inf"), device=d2.device)
    for _ in range(iters):
        h, _ = entropy(beta)
        too_high = h[:, None] > target  # too flat: sharpen (raise beta)
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        up = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) * 0.5)
        down = torch.where(lo == 0.0, beta * 0.5, (beta + lo) * 0.5)
        beta, lo, hi = torch.where(too_high, up, down), new_lo, new_hi
    return entropy(beta)[1]


def joint_probabilities(x: torch.Tensor, perplexity: float, iters: int = 64) -> torch.Tensor:
    """Symmetrised, globally normalised P (sklearn `_joint_probabilities`)."""
    pc = conditional_probabilities(_pairwise_sq_dists(x), perplexity, iters)
    p = pc + pc.T
    p = p / p.sum().clamp_min(_EPS)
    return p.clamp_min(_EPS)


def _kl_and_grad(y: torch.Tensor, p: torch.Tensor,
                 exaggeration) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL(P || Q) and its gradient for the Student-t kernel:
    grad_i = 4 sum_j (e P_ij - Q_ij) q~_ij (y_i - y_j), a row-sum rescale
    plus one [n, n] x [n, dim] product."""
    n = y.shape[0]
    qnum = 1.0 / (1.0 + _pairwise_sq_dists(y))
    qnum = qnum * (1.0 - torch.eye(n, dtype=qnum.dtype, device=qnum.device))
    z = qnum.sum().clamp_min(_EPS)
    q = (qnum / z).clamp_min(_EPS)
    w = (exaggeration * p - q) * qnum
    grad = 4.0 * (w.sum(1, keepdim=True) * y - w @ y)
    kl = (p * (torch.log(p) - torch.log(q))).sum()
    return kl, grad


def _tsne_optimize(
    p: torch.Tensor,  # [n, n] joint probabilities
    y0: torch.Tensor,  # [n, dim] start
    n_iter: int,
    exaggeration_iters: int,
    early_exaggeration: float,
    learning_rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sklearn's `_gradient_descent` for `n_iter` steps: (y, KL per step)."""
    y, vel, gains = y0.float(), torch.zeros_like(y0).float(), torch.ones_like(y0).float()
    kls = []
    for it in range(n_iter):
        early = it < exaggeration_iters
        kl, grad = _kl_and_grad(y, p, early_exaggeration if early else 1.0)
        momentum = 0.5 if early else 0.8
        same_dir = torch.sign(grad) == torch.sign(vel)
        gains = torch.where(same_dir, gains * 0.8, gains + 0.2).clamp_min(0.01)
        vel = momentum * vel - learning_rate * gains * grad
        y = y + vel
        kls.append(kl)
    return y, torch.stack(kls)


def tsne(
    x: torch.Tensor,  # [n, d]
    dim: int = 2,
    perplexity: float = 30.0,
    n_iter: int = 500,
    early_exaggeration: float = 12.0,
    exaggeration_iters: int = 250,
    learning_rate: Optional[float] = None,  # None: sklearn's "auto"
    init: str = "pca",  # "pca" (deterministic) | "random"
    key=None,  # an Rng, for init="random"
    calibration_iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed [n, d] -> [n, dim]; returns (embedding, KL per iteration).
    The PCA start's signs are the eigensolver's (LAPACK may pick other
    ones than JAX's solver); init="random" draws 1e-4 N(0, 1) from `key`."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n < 4:
        raise ValueError(f"t-SNE needs n >= 4, got {n}")
    # sklearn needs perplexity < n, and 3 * perplexity neighbours: clamp
    perplexity = min(float(perplexity), (n - 1) / 3.0)
    p = joint_probabilities(x, perplexity, calibration_iters)

    if init == "pca":
        from msvit_tpu_torch.ops.linalg import pca_lowrank

        xf = x.float()
        _, _, v = pca_lowrank(xf, q=dim)
        y0 = (xf - xf.mean(0)) @ v[:, :dim]
        y0 = y0 / y0[:, 0].std(correction=0).clamp_min(_EPS) * 1e-4  # sklearn's scaling
    elif init == "random":
        if key is None:
            raise ValueError('init="random" needs an explicit key')
        y0 = 1e-4 * key.normal((n, dim), x.device)
    else:
        raise ValueError(f"unknown init {init!r}")

    if learning_rate is None:
        learning_rate = max(n / early_exaggeration / 4.0, 50.0)
    return _tsne_optimize(p, y0, n_iter, exaggeration_iters, float(early_exaggeration),
                          float(learning_rate))
