"""Fixed-iteration KMeans (counterpart of `msvit_tpu/ops/kmeans.py`).

Lloyd's loop with a fixed number of iterations and the JAX package's two
static-shape extensions: `active` (only those centers take part: the
data-dependent child count of the clustering module becomes a center
mask) and `mask` (only member points update centers).  Everything stays
on the device: no data-dependent shapes, no host sync.

Batched over a leading parent axis: `x [C, n, d]` with one random stream
per parent (the JAX package vmaps the single-parent function; the same
streams give the same draws).  A single `x [n, d]` with one stream works
as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, the lower index
    first among equal values (`jax.lax.top_k`'s order; `torch.topk` does
    not promise one): a stable descending sort, sliced."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def gumbel_top_k(keys: Sequence, member: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct members per row of `member [C, n]` by Gumbel top-k
    (weighted sampling without replacement); row c draws its noise from
    `keys[c]` as `uniform((n,), 1e-9, 1)`.  Non-members score -inf, so a
    row with fewer than k members takes non-members by index order."""
    n = member.shape[-1]
    u = torch.stack([key.uniform((n,), 1e-9, 1.0, member.device) for key in keys])
    g = -torch.log(-torch.log(u))
    return top_k_indices(torch.where(member, g, -torch.inf), k)


def kmeans(
    x: torch.Tensor,  # [n, d] or [C, n, d]
    k: int,
    key,  # an Rng, or one per parent for a batched x
    iters: int = 16,
    active: Optional[torch.Tensor] = None,  # [(C,) k] bool (default: all)
    mask: Optional[torch.Tensor] = None,  # [(C,) n] bool (default: all)
    init_centers: Optional[torch.Tensor] = None,  # [(C,) k, d]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (labels [(C,) n] int64 in [0, k), centers [(C,) k, d] f32).
    Labels of masked-out points are arbitrary (the nearest active center).
    Without `init_centers` the initial centers are k member points drawn
    by Gumbel top-k."""
    single = x.ndim == 2
    if single:
        x, keys = x[None], [key]
        active = None if active is None else active[None]
        mask = None if mask is None else mask[None]
        init_centers = None if init_centers is None else init_centers[None]
    else:
        keys = list(key)
    c, n, d = x.shape
    x = x.float()
    dev = x.device
    member = (torch.ones((c, n), dtype=torch.bool, device=dev) if mask is None
              else mask.bool())
    act = (torch.ones((c, k), dtype=torch.bool, device=dev) if active is None
           else active.bool())

    if init_centers is None:
        idx = gumbel_top_k(keys, member, k)  # [C, k]
        centers = torch.gather(x, 1, idx[..., None].expand(c, k, d))
    else:
        centers = init_centers.float()

    x_sq = (x * x).sum(-1)[..., None]  # [C, n, 1]
    inactive = ~act[:, None, :]
    ids = torch.arange(k, device=dev)

    def assign(centers):
        d2 = x_sq - 2.0 * (x @ centers.mT) + (centers * centers).sum(-1)[:, None, :]
        return d2.masked_fill(inactive, torch.inf).argmin(-1)  # first minimum

    for _ in range(iters):
        onehot = (assign(centers)[..., None] == ids).float() * member[..., None]
        counts = onehot.sum(1)  # [C, k]
        new = (onehot.mT @ x) / counts.clamp_min(1.0)[..., None]
        # empty clusters keep their previous center
        centers = torch.where((counts > 0)[..., None], new, centers)
    labels = assign(centers)
    return (labels[0], centers[0]) if single else (labels, centers)
