"""Math helpers (the port's copies of `msvit_tpu/utils/math.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch


def ceildiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def pow_series(m: torch.Tensor, n: int) -> torch.Tensor:
    """Matrix powers ``[I, M, M^2, ..., M^(n-1)]`` as [n, N, N], by doubling:
    powers[k:2k] = powers[:k] @ M^k."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    if n == 1:
        return eye[None]
    out = torch.stack([eye, m])
    block = m
    for _ in range(int(math.ceil(math.log2(n))) - 1):
        block = block @ block
        out = torch.cat([out, out @ block], dim=0)
    return out[:n]


def batch_trace(x: torch.Tensor) -> torch.Tensor:
    """Trace over the last two axes."""
    return x.diagonal(dim1=-2, dim2=-1).sum(-1)


def gaussian_kl(cov1: torch.Tensor, cov2: torch.Tensor) -> torch.Tensor:
    """KL(N(0, cov1) || N(0, cov2)):
    (log det cov2 - log det cov1 - d + tr(cov2^-1 cov1)) / 2, the trace as an
    elementwise product sum (the covariances are symmetric)."""
    d = cov1.shape[-1]
    _, logdet1 = torch.linalg.slogdet(cov1)
    _, logdet2 = torch.linalg.slogdet(cov2)
    trace_term = (torch.linalg.inv(cov2) * cov1).sum((-2, -1))
    return (logdet2 - logdet1 - d + trace_term) / 2


def sqrtm(t: torch.Tensor) -> torch.Tensor:
    """Principal square root of symmetric PSD matrices by `eigh`, the
    eigenvalues clamped at 0."""
    w, v = torch.linalg.eigh(t)
    w = w.clamp_min(0.0).sqrt()
    return (v * w[..., None, :]) @ v.transpose(-1, -2)


def multiclass_logits(t: torch.Tensor) -> torch.Tensor:
    """Centered log over the last axis: log t minus its mean."""
    logits = torch.log(t)
    return logits - logits.mean(-1, keepdim=True)


def _mnpq(x_mn: torch.Tensor, y_pq: torch.Tensor) -> torch.Tensor:
    """Outer broadcast [..., m, n] x [..., p, q] -> [..., m, n, p, q]."""
    return x_mn[..., :, :, None, None] * y_pq[..., None, None, :, :]


def hadamard_conjugation(a, b, alpha, beta, c):
    """sum_{m,p} A[m,n] B[p,q] C[m,p] / (1 - alpha[m,n] beta[p,q]) -> [..., n, q]:
    the geometric series sum_k (alpha o)^k A^T C B (beta o)^k in closed form."""
    coeff = 1.0 / (1.0 - _mnpq(alpha, beta))
    return torch.einsum("...mn,...pq,...mp,...mnpq->...nq", a, b, c, coeff)


def hadamard_conjugation_diff_order1(a, b, alpha, beta1, beta2, c):
    """The difference quotient of `hadamard_conjugation` in beta: the
    alpha / (1 - alpha beta1)(1 - alpha beta2) kernel."""
    coeff = alpha[..., :, :, None, None] / (
        (1.0 - _mnpq(alpha, beta1)) * (1.0 - _mnpq(alpha, beta2)))
    return torch.einsum("...mn,...pq,...mp,...mnpq->...nq", a, b, c, coeff)


def hadamard_conjugation_diff_order2(b, beta1, beta2, c):
    """The second-order difference: kernel (1 - b12 b21) / (1 - b1 b1')
    (1 - b12)(1 - b21)(1 - b2 b2'), b12[m,n,p,q] = beta1[m,n] beta2[p,q] and
    b21 its (m<->p, n<->q) transpose."""
    beta12 = _mnpq(beta1, beta2)
    beta21 = _mnpq(beta2, beta1)
    coeff = (1.0 - beta12 * beta21) / (
        (1.0 - _mnpq(beta1, beta1)) * (1.0 - beta12) * (1.0 - beta21)
        * (1.0 - _mnpq(beta2, beta2)))
    return torch.einsum("...mn,...pq,...mp,...mnpq->...nq", b, b, c, coeff)


class InverseCubic(torch.autograd.Function):
    """Inverse of x -> (3 sqrt(3) / 2) (x^3 / 3 + x) / sqrt(3): the forward
    solves the depressed cubic in closed form; the backward is
    1 / (r^2 + 1) of the forward's r (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, t):
        c = t * 2.598076211353
        k = torch.pow(torch.sqrt(c * c + 1.0) + c, 1.0 / 3.0)  # > 0: a real cube root
        r = k - 1.0 / k
        ctx.save_for_backward(r)
        return 0.577350269190 * r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return g / (r * r + 1.0)


def inverse_cubic(t: torch.Tensor) -> torch.Tensor:
    return InverseCubic.apply(t)


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in f32 step for step: start (1 - t)
    + stop t with t = i / (num - 1) for i < num - 1, then stop itself (the
    bounds rounded to f32 first; no host-to-device copy)."""
    lo, hi = float(np.float32(start)), float(np.float32(stop))
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([lo * (1.0 - t) + hi * t,
                      torch.full((1,), hi, dtype=torch.float32, device=device)])
