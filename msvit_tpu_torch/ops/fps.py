"""Farthest point sampling (counterpart of `msvit_tpu/ops/fps.py`).

Greedy max-min selection: each step takes the point farthest from the
points taken so far.  The blocked variant runs G exact chains of k/G steps
on G spatial buckets at once, as one batched `[G, n/G, d]` loop (the JAX
package vmaps the chains), so its serial depth is k/G.  Indices stay on
the device: no host sync.

Randomness: the first pick is a Gumbel argmax drawn through an `Rng`
(utils/rng.py) as `uniform((n,), 1e-9, 1)`, JAX's bounds; the blocked
variant gives chain g the stream `key.split(G)[g]`.  The `*_images`
functions run independent point sets side by side (x [I, n, d], one
stream row of I streams: the images of a per-image clustering call).
"""

from __future__ import annotations

from typing import Optional

import torch

from msvit_tpu_torch.ops.kmeans import gather_rows
from msvit_tpu_torch.utils.rng import KeyRows, uniform_rows


def _fps_chains(x: torch.Tensor, k: int, u: Optional[torch.Tensor],
                member: torch.Tensor) -> torch.Tensor:
    """Exact FPS of k points in each chain: x [..., m, d], member [..., m]
    bool, u [..., m] the first pick's uniforms (None: the first member
    first) -> local indices [..., k] int64."""
    x = x.float()
    if u is not None:
        first = torch.where(member, -torch.log(-torch.log(u)), -torch.inf).argmax(-1)
    else:
        first = member.to(torch.uint8).argmax(-1)  # the first member
    sq = (x * x).sum(-1)  # [..., m]

    def dist_to(i):  # [...] -> [..., m], non-members -inf
        xi = gather_rows(x, i[..., None])[..., 0, :]
        d = (sq + torch.gather(sq, -1, i[..., None])
             - 2.0 * torch.einsum("...md,...d->...m", x, xi))
        return torch.where(member, d, -torch.inf)

    idx = [first]
    min_d = dist_to(first)
    for _ in range(1, k):
        nxt = min_d.argmax(-1)
        idx.append(nxt)
        min_d = torch.minimum(min_d, dist_to(nxt))
    return torch.stack(idx, dim=-1)


def farthest_point_sampling_images(
    x: torch.Tensor,  # [I, n, d]
    k: int,
    key=None,  # a stream row (I streams)
    member: Optional[torch.Tensor] = None,  # [I, n] bool
) -> torch.Tensor:
    """`farthest_point_sampling` of I point sets side by side: [I, k]."""
    if member is None:
        member = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    u = None if key is None else key.uniform((x.shape[1],), 1e-9, 1.0, x.device)
    return _fps_chains(x, k, u, member.bool())


def farthest_point_sampling(
    x: torch.Tensor,  # [n, d]
    k: int,
    key=None,  # an Rng
    mask: Optional[torch.Tensor] = None,  # [n] bool
) -> torch.Tensor:
    """k indices [k] int64 by greedy max-min selection.  The first point is
    random (with `key`) or index 0; masked-out points are never taken."""
    return farthest_point_sampling_images(
        x[None], k, None if key is None else KeyRows([key]),
        None if mask is None else mask[None])[0]


def farthest_point_sampling_blocked_images(
    x: torch.Tensor,  # [I, n, d]
    k: int,
    key=None,  # a stream row (I streams)
    member: Optional[torch.Tensor] = None,  # [I, n] bool
    groups: int = 8,
) -> torch.Tensor:
    """`farthest_point_sampling_blocked` of I point sets side by side:
    [I, k]."""
    i_sets, n = x.shape[:2]
    g = groups
    while k % g:
        g //= 2
    if g <= 1:
        return farthest_point_sampling_images(x, k, key, member)
    dev = x.device
    if member is None:
        member = torch.ones((i_sets, n), dtype=torch.bool, device=dev)
    member = member.bool()
    # masked-out points sort to the end (a stable sort, as jnp.argsort)
    perm = torch.argsort(torch.where(member, x[..., 0].float(), torch.inf), dim=-1,
                         stable=True)
    n_pad = -(-n // g) * g
    perm_p = torch.cat([perm, perm[:, : n_pad - n]], dim=-1)  # [I, n_pad]
    xg = gather_rows(x, perm_p).reshape(i_sets, g, n_pad // g, -1)
    mg = torch.gather(member, -1, perm_p) & (torch.arange(n_pad, device=dev) < n)
    u = None if key is None else uniform_rows(key.split(g), (n_pad // g,), 1e-9, 1.0, dev)
    sub = _fps_chains(xg, k // g, u, mg.reshape(i_sets, g, n_pad // g))  # [I, g, k/g]
    flat = sub + (torch.arange(g, device=dev) * (n_pad // g))[:, None]
    return torch.gather(perm_p, -1, flat.reshape(i_sets, -1))


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
    return farthest_point_sampling_blocked_images(
        x[None], k, None if key is None else KeyRows([key]),
        None if mask is None else mask[None], groups)[0]
