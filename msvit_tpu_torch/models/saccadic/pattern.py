"""Learned Gaussian "patterns" and the wildcard-stratified beam search
matcher (counterpart of `msvit_tpu/models/saccadic/pattern.py`).

A pattern of complexity K is a joint Gaussian over K slot embeddings, each
slot with covariance shift * I + A A^T (A [D, d], the slots' factors sharing
a d-dimensional space).  `match` binds tokens to slots greedily: each step
scores every (beam entry, unfilled slot, candidate token) by its Gaussian
log-pdf, keeps the global top `beam_size`, and conditions the remaining
slots on the bound one (rank-d adapter h with h h^T = (I + G)^-1).  A
pattern of complexity K runs exactly K binding steps, so every shape is
static; the first step searches only `hidden_states`, so every match binds
at least one new node.

Ties and order, as in JAX: the top-k is a stable descending sort cut at k
(`lax.top_k` keeps the lower index first among equal scores; `torch.topk`
promises no order), and the two `argsort`s are stable.

The batched products whose one side is shared across the batch (the
initial bank has batch dimension 1) are `einsum`s: a dimension of size 1
on one side is not expanded, where `matmul` would copy the bank B times.

Decompositions (`SaccadicViTConfig.matcher_solver`): "chol" factors
I + G = L L^T (`cholesky_ex`: no host sync) and takes h = L^-T, "eigh" the
Gram's eigendecomposition (`torch.linalg.eigh` checks its result on the
host: one sync per call on the card).  The two give equal log-pdfs and
conditional means; their factors differ by a rotation no consumer sees.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from msvit_tpu_torch.models.saccadic.config import SaccadicViTConfig

WILDCARD = -1


def _datan_exp_h(t: torch.Tensor) -> torch.Tensor:
    """rsqrt(1 + exp(t))."""
    return torch.rsqrt(1.0 + torch.exp(t))


def _demean(search, mean, log_shift):
    """(x - mu) / sqrt(shift) for every (beam, slot, token): [B, W, R, M, D]."""
    demean = search[:, None, None, :, :] - mean[..., None, :]
    return demean * torch.exp(-0.5 * log_shift)


def _log_pdf(scaled, norm_demean, logdet, log_shift):
    d_model = scaled.shape[-1]
    constant = -0.5 * d_model * math.log(2.0 * math.pi)
    determinant = -0.5 * (d_model * log_shift + logdet)  # [B, W, R]
    exponent = -0.5 * ((scaled**2).sum(-1) - (norm_demean**2).sum(-1))
    return constant + determinant[..., None] + exponent


def gaussian_low_rank_log_pdf(
    search: torch.Tensor,  # [B, M, D]
    mean: torch.Tensor,  # [B|1, W, R, D]
    cov: torch.Tensor,  # [B|1, W, R, D, d]
    log_shift: torch.Tensor,  # scalar
):
    """log N(x; mu, shift I + A A^T) for every (beam, slot, token), through
    the eigendecomposition of the factor's d x d Gram (its thin SVD).
    Returns (log_pdf [B, W, R, M], norm_demean [B, W, R, M, d],
    log_l [B|1, W, R, d], v [B|1, W, R, d, d])."""
    scaled = _demean(search, mean, log_shift)
    gram = torch.einsum("...di,...dj->...ij", cov, cov)
    w, v = torch.linalg.eigh(gram)  # ascending
    w, v = w.flip(-1), v.flip(-1)
    s = torch.sqrt(w.clamp_min(0.0))
    s_inv = torch.where(s > 1e-10, 1.0 / s.clamp_min(1e-10), 0.0)
    u = cov @ (v * s_inv[..., None, :])  # [B|1, W, R, D, d]
    log_l = 2.0 * torch.log(s.clamp_min(1e-20)) - log_shift
    norm_u = u * _datan_exp_h(-log_l)[..., None, :]
    norm_demean = torch.einsum("bwrmD,bwrDd->bwrmd", scaled, norm_u)
    logdet = torch.log1p(torch.exp(log_l)).sum(-1)
    return _log_pdf(scaled, norm_demean, logdet, log_shift), norm_demean, log_l, v


def gaussian_low_rank_log_pdf_chol(
    search: torch.Tensor,  # [B, M, D]
    mean: torch.Tensor,  # [B|1, W, R, D]
    cov: torch.Tensor,  # [B|1, W, R, D, d]
    log_shift: torch.Tensor,  # scalar
):
    """The Cholesky-Woodbury route to the same density: with
    Sigma = shift I + A A^T, B = A / sqrt(shift), G = B^T B and
    I + G = L L^T, log det Sigma = D log shift + 2 sum log L_ii and
    (x - mu)^T Sigma^-1 (x - mu) = |y|^2 - |y^T B L^-T|^2, y the scaled
    demean; the conditioning adapter is h = L^-T.  Returns (log_pdf
    [B, W, R, M], norm_demean [B, W, R, M, d], h [B|1, W, R, d, d])."""
    d = cov.shape[-1]
    scaled = _demean(search, mean, log_shift)
    bmat = cov * torch.exp(-0.5 * log_shift)
    gram = torch.einsum("...di,...dj->...ij", bmat, bmat)
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    chol = torch.linalg.cholesky_ex(gram + eye).L  # I + G >= I: never singular
    # L^T h = I (JAX: left_side, lower, transpose_a)
    h = torch.linalg.solve_triangular(chol.mT, eye.expand(chol.shape), upper=True)
    proj = torch.einsum("bwrmD,bwrDd->bwrmd", scaled, bmat)
    norm_demean = torch.einsum("bwrmd,bwrde->bwrme", proj, h)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return _log_pdf(scaled, norm_demean, logdet, log_shift), norm_demean, h


def _matcher_solve(search, mean, cov, log_shift, solver: str):
    """(log_pdf, norm_demean, h) by either decomposition, h h^T = (I+G)^-1."""
    if solver == "chol":
        return gaussian_low_rank_log_pdf_chol(search, mean, cov, log_shift)
    if solver == "eigh":
        log_pdf, norm_demean, log_l, v = gaussian_low_rank_log_pdf(
            search, mean, cov, log_shift)
        return log_pdf, norm_demean, v * _datan_exp_h(log_l)[..., None, :]
    raise ValueError(f"unknown matcher_solver {solver!r}")


def _gather_beam(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B|1, W, ...], idx [B, beam] -> arr[b, idx[b]] [B, beam, ...]
    (a batch-1 array serves every image without a copy)."""
    if arr.shape[0] == 1:
        return arr[0][idx]
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return arr[rows, idx]


def _gather_slot(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, beam, R, ...], idx [B, beam] -> arr[b, j, idx[b, j]]
    [B, beam, ...]."""
    b, beam = idx.shape
    rows = torch.arange(b, device=idx.device)[:, None]
    cols = torch.arange(beam, device=idx.device)[None, :]
    return arr[rows, cols, idx]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries along the last axis, largest
    first and the lower index first among ties (`lax.top_k`'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class SaccadicViTMultiStatePattern(nn.Module):
    """The pattern bank and its matcher.  Keys: ``mean_<K> [V, K, D]``,
    ``std_<K> [V, K, D, d]`` for each (K, V) of `num_patterns`, and
    ``log_covariance_shift`` (a scalar); all drawn N(0, 1) but the shift,
    which starts at `config.log_covariance_shift`."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d_model, d = config.hidden_size, config.covariance_dim
        for k, v in config.num_patterns:
            setattr(self, f"mean_{k}", nn.Parameter(
                torch.randn((v, k, d_model), generator=generator)))
            setattr(self, f"std_{k}", nn.Parameter(
                torch.randn((v, k, d_model, d), generator=generator)))
        self.log_covariance_shift = nn.Parameter(
            torch.tensor(float(config.log_covariance_shift)))

    def forward(self, hidden_states, context_states, max_wildcards: int = 0):
        return self.match(hidden_states, context_states, max_wildcards)

    def match(
        self,
        hidden_states: torch.Tensor,  # [B, N, D]
        context_states: torch.Tensor,  # [B, C, D]
        max_wildcards: int = 0,
    ) -> Dict[Tuple[int, int], Dict[str, torch.Tensor]]:
        """{(complexity, n_wildcards): {pattern_index [B, W], node_indices
        [B, W, K] (-1: a wildcard; < N a hidden node, >= N context),
        joint_log_pdf [B, W], conditional_mean [B, W, n_wild, D],
        conditional_covariance [B, W, n_wild, D, d]}}, in the order JAX
        builds it (by complexity, then by binding step)."""
        cfg = self.config
        b, n, _ = hidden_states.shape
        dev = hidden_states.device
        log_shift = self.log_covariance_shift
        hidden_f32 = hidden_states.float()
        full_search = torch.cat([hidden_states, context_states], dim=1).float()
        output: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}

        for k, v in cfg.num_patterns:
            # the initial beam: every pattern, every slot a wildcard; the bank
            # keeps batch dimension 1 until the first gather
            pattern_index = torch.arange(v, device=dev).expand(b, v)
            nodes = torch.full((b, v, k), WILDCARD, dtype=torch.long, device=dev)
            joint_state = torch.zeros(b, v, device=dev)
            mean = getattr(self, f"mean_{k}")[None].float()
            cov = getattr(self, f"std_{k}")[None].float()

            for it in range(k):
                r = k - it  # slots remaining
                w = pattern_index.shape[1]
                search = hidden_f32 if (it == 0 and n > 0) else full_search
                m = search.shape[1]
                beam = min(cfg.beam_size, w * r * m)

                log_pdf, norm_demean, hmat = _matcher_solve(
                    search, mean, cov, log_shift, cfg.matcher_solver)
                joint = joint_state[:, :, None, None] + log_pdf  # [B, W, R, M]

                flat_idx = top_k_indices(joint.reshape(b, -1), beam)
                w_idx = flat_idx // (r * m)
                rem = flat_idx % (r * m)
                r_idx = rem // m
                m_idx = rem % m

                pattern_index = pattern_index.gather(1, w_idx)
                nodes_g = _gather_beam(nodes, w_idx)
                mean_g = _gather_beam(mean, w_idx)
                cov_g = _gather_beam(cov, w_idx)
                h_sel = _gather_slot(_gather_beam(hmat, w_idx), r_idx)  # [B, beam, d, d]
                nd_sel = _gather_slot(_gather_beam(norm_demean, w_idx), r_idx)  # [B, beam, M, d]
                nd_sel = nd_sel.gather(2, m_idx[:, :, None, None].expand(
                    -1, -1, 1, nd_sel.shape[-1]))[:, :, 0]  # [B, beam, d]
                pdf_sel = _gather_slot(_gather_beam(joint, w_idx), r_idx)  # [B, beam, M]
                joint_state = pdf_sel.gather(2, m_idx[:, :, None])[:, :, 0]

                # bind the selected slot: the r_idx-th wildcard position
                wildcard_pos = torch.argsort((nodes_g != WILDCARD).to(torch.uint8), dim=-1,
                                             stable=True)[..., :r]
                sel_pos = wildcard_pos.gather(-1, r_idx[:, :, None])[..., 0]
                slot = torch.arange(k, device=dev)[None, None, :]
                nodes = torch.where(slot == sel_pos[:, :, None], m_idx[:, :, None], nodes_g)

                # Gaussian conditioning of the unselected slots
                unsel = torch.argsort(
                    (torch.arange(r, device=dev)[None, None, :] == r_idx[:, :, None]).to(
                        torch.uint8), dim=-1, stable=True)[..., : r - 1]  # [B, beam, r-1]
                mean_u = mean_g.gather(2, unsel[..., None].expand(-1, -1, -1, mean_g.shape[-1]))
                cov_u = cov_g.gather(2, unsel[..., None, None].expand(
                    -1, -1, -1, *cov_g.shape[-2:]))
                cov_u = cov_u @ h_sel[:, :, None]
                mean = mean_u + (cov_u @ nd_sel[:, :, None, :, None])[..., 0]
                cov = cov_u

                if r - 1 <= max_wildcards:
                    output[(k, r - 1)] = {
                        "pattern_index": pattern_index,
                        "node_indices": nodes,
                        "joint_log_pdf": joint_state,
                        "conditional_mean": mean,
                        "conditional_covariance": cov,
                    }
        return output
