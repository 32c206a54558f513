"""Farthest point sampling (counterpart of `msvit_tpu/ops/fps.py`).

Greedy max-min selection: each step takes the point farthest from the
points taken so far.  The blocked variant runs G exact chains of k/G steps
on G spatial buckets at once, as one batched `[G, n/G, d]` loop (the JAX
package vmaps the chains), so its serial depth is k/G.  Indices stay on
the device: no host sync.

Randomness: the first pick is a Gumbel argmax drawn through an `Rng`
(utils/rng.py) as `uniform((n,), 1e-9, 1)`, JAX's bounds; the blocked
variant gives chain g the stream `key.split(G)[g]`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from msvit_tpu_torch.utils.rng import uniform_rows


def _fps_chains(x: torch.Tensor, k: int, keys: Optional[Sequence],
                member: torch.Tensor) -> torch.Tensor:
    """Exact FPS of k points in each of G chains: x [G, m, d], member
    [G, m] bool, one stream per chain (None: the first member first) ->
    local indices [G, k] int64."""
    g, m, _ = x.shape
    x = x.float()
    dev = x.device
    if keys is not None:
        u = uniform_rows(keys, (m,), 1e-9, 1.0, dev)
        first = torch.where(member, -torch.log(-torch.log(u)), -torch.inf).argmax(-1)
    else:
        first = member.to(torch.uint8).argmax(-1)  # the first member
    sq = (x * x).sum(-1)  # [G, m]
    rows = torch.arange(g, device=dev)

    def dist_to(i):  # [G] -> [G, m], non-members -inf
        d = sq + sq[rows, i][:, None] - 2.0 * torch.einsum("gmd,gd->gm", x, x[rows, i])
        return torch.where(member, d, -torch.inf)

    idx = [first]
    min_d = dist_to(first)
    for _ in range(1, k):
        nxt = min_d.argmax(-1)
        idx.append(nxt)
        min_d = torch.minimum(min_d, dist_to(nxt))
    return torch.stack(idx, dim=1)


def farthest_point_sampling(
    x: torch.Tensor,  # [n, d]
    k: int,
    key=None,  # an Rng
    mask: Optional[torch.Tensor] = None,  # [n] bool
) -> torch.Tensor:
    """k indices [k] int64 by greedy max-min selection.  The first point is
    random (with `key`) or index 0; masked-out points are never taken."""
    member = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
              if mask is None else mask.bool())
    return _fps_chains(x[None], k, None if key is None else [key], member[None])[0]


def farthest_point_sampling_blocked(
    x: torch.Tensor,  # [n, d]
    k: int,
    key=None,  # an Rng
    mask: Optional[torch.Tensor] = None,  # [n] bool
    groups: int = 8,
) -> torch.Tensor:
    """Approximate FPS by G parallel greedy chains (the JAX package's
    `farthest_point_sampling_blocked`): the points sorted by coordinate 0
    (callers pass PCA-ed data: the principal direction) are cut into G
    contiguous buckets, wrap-padded to equal size (a duplicate is masked in
    its second bucket), and exact FPS of k/G points runs in each.  G halves
    until it divides k; at G = 1 this is `farthest_point_sampling`.
    Returns [k] int64, bucket by bucket."""
    n = x.shape[0]
    g = groups
    while k % g:
        g //= 2
    if g <= 1:
        return farthest_point_sampling(x, k, key=key, mask=mask)
    dev = x.device
    member = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    # masked-out points sort to the end (a stable sort, as jnp.argsort)
    perm = torch.argsort(torch.where(member, x[:, 0].float(), torch.inf), stable=True)
    n_pad = -(-n // g) * g
    perm_p = torch.cat([perm, perm[: n_pad - n]])
    xg = x[perm_p].reshape(g, n_pad // g, -1)
    mg = member[perm_p] & (torch.arange(n_pad, device=dev) < n)
    sub = _fps_chains(xg, k // g, None if key is None else key.split(g),
                      mg.reshape(g, n_pad // g))
    flat = sub + (torch.arange(g, device=dev) * (n_pad // g))[:, None]
    return perm_p[flat.reshape(-1)]
