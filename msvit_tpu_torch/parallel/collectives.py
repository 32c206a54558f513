"""Autograd-aware collectives of the tensor-parallel trunk (the Megatron
f/g pairs and their sequence-parallel forms), on plain local tensors.

The kernels the trunk runs (K1, K1-lse, K2, K3 as registered ops, the rest
through ctypes) take plain tensors, not DTensors, so the trunk under tensor
parallelism computes on each rank's local shards and states its
communication here.  Every function takes a `ModelParallel`, the "model"
group of a mesh with this rank's place in it.

Names say what the forward does; the backward is its transpose:

* `copy_to_model` (f): identity; backward all-reduces (the input of a
  column-parallel layer, whose ranks each give a partial gradient);
* `reduce_from_model` (g): all-reduce; backward identity (the output of a
  row-parallel layer, read alike on every rank);
* `gather_tokens` (g of sequence parallelism): all-gather the token axis;
  backward reduce-scatter (consumers are column-parallel: partial
  gradients);
* `reduce_scatter_tokens`: reduce-scatter the token axis; backward
  all-gather (a row-parallel output going back to sharded tokens);
* `split_tokens`: this rank's chunk of a tensor every rank holds whole;
  backward all-gather;
* `gather_tokens_replicated`: all-gather the token axis for consumers that
  every rank computes alike; backward takes this rank's chunk.

Tokens (dim 1) are cut into `tp` chunks of ``c = ceil(N / tp)``; the last
is padded with zeros, which no output reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(eq=False)
class ModelParallel:
    """A rank's place in the "model" group.  `seq`: tokens are sharded on
    the group between blocks (``config.sequence_sharding``); `tokens` is the
    unsharded token count of the forward in flight (set by the encoder)."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    seq: bool = False
    tokens: Optional[int] = None

    def chunk(self, n: int) -> int:
        return -(-n // self.size)

    def token_slice(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's token chunk of a whole tensor (zero-padded)."""
        c = self.chunk(x.shape[dim])
        return _pad(x, dim, c * self.size).narrow(dim, self.rank * c, c)


def _pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    if x.shape[dim] == n:
        return x
    pad = [0, 0] * (x.ndim - dim - 1) + [0, n - x.shape[dim]]
    return F.pad(x, pad)


def _all_gather(x: torch.Tensor, mp: ModelParallel, dim: int) -> torch.Tensor:
    if mp.group is None:  # an axis the caller did not shard on
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] * mp.size,) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=mp.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mp: ModelParallel, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // mp.size,) + xt.shape[1:])
    dist.reduce_scatter_tensor(out, xt, group=mp.group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mp.group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return _all_reduce(x, mp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, n, replicated):
        ctx.mp, ctx.n, ctx.replicated = mp, x.shape[1], replicated
        return _all_gather(x, mp, 1).narrow(1, 0, n)

    @staticmethod
    def backward(ctx, g):
        mp, c = ctx.mp, ctx.n
        if ctx.replicated:
            return mp.token_slice(g), None, None, None
        return _reduce_scatter(_pad(g, 1, c * mp.size), mp, 1), None, None, None


class _ReduceScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp, ctx.n = mp, x.shape[1]
        return _reduce_scatter(_pad(x, 1, mp.chunk(x.shape[1]) * mp.size), mp, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mp, 1).narrow(1, 0, ctx.n), None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp, ctx.n = mp, x.shape[1]
        return mp.token_slice(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mp, 1).narrow(1, 0, ctx.n), None


def copy_to_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mp)


def gather_tokens(x: torch.Tensor, mp: ModelParallel, n: int) -> torch.Tensor:
    """[B, c, ...] local chunk -> [B, n, ...] (backward reduce-scatter)."""
    return _GatherTokens.apply(x, mp, n, False)


def gather_tokens_replicated(x: torch.Tensor, mp: ModelParallel, n: int) -> torch.Tensor:
    """[B, c, ...] local chunk -> [B, n, ...] (backward: this rank's chunk)."""
    return _GatherTokens.apply(x, mp, n, True)


def reduce_scatter_tokens(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """[B, n, ...] partial sums -> [B, c, ...] this rank's chunk of the sum."""
    return _ReduceScatterTokens.apply(x, mp)


def split_tokens(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """[B, n, ...] whole on every rank -> [B, c, ...] this rank's chunk."""
    return _SplitTokens.apply(x, mp)
