"""Ring attention: exact attention with the token axis sharded on the
mesh's "model" axis (counterpart of `msvit_tpu/parallel/ring_attention.py`).

Each of the s ranks of the "model" group holds its block of n = N/s
queries, keys and values ``[b, n, H, dh]``.  At step t a rank attends its
queries to the key/value block that started t ranks back, then passes the
block on (`batch_isend_irecv`, posted before the step's compute so the
transfer overlaps it): s steps, s - 1 hops.  An optional key-padding mask
``[b, n]`` (True = attend) rides the ring with its block.

* **The local block is K7-lse** (`ops/flash_attention.py::
  flash_attention_lse`; its plain version on the CPU): each step gives the
  block's normalised output and its lse, and the blocks are merged through
  their lse in f32, ``o = sum_t exp(lse_t - lse) o_t``.  The mask reaches
  K7 as a key-only mask ``[b, 1, 1, n]`` (row stride 0, never expanded).
  A block whose keys are all masked for a batch element adds nothing: its
  lse is taken as -inf (K7's mask value is finite, so its own lse there is
  mask_value + log n, and for an additive -inf mask 0); a query with no
  key at all gives 0, as JAX's ring.
* **The backward is a `torch.autograd.Function`**, since autograd does not
  cross `isend`/`irecv`: the ring runs again with K6
  (`flash_attention_bwd`) on each block, given the *global* out and lse,
  which makes each block's dq, dk, dv exact.  dk and dv travel with their
  block and arrive home after s hops.
* Scores in f32 for f32 inputs (K7's f32 path: JAX's ring computes in f32
  whatever the dtype); bf16 inputs take K7's tensor-core path, whose p is
  rounded to bf16 into P.V.

`ring_attention` takes the whole ``[B, N, H, dh]`` on every rank, as JAX's
caller sees the global array, and returns the whole output: batch split on
"data", tokens on "model", gathered at the end (differentiable: the
gradient of the input is summed over the ranks' parts).
`ring_attention_local` is the ring itself, on each rank's blocks.
`ring_attention_single_process` runs every rank's ring in one process
through the same `RingAttentionFunction` (the hand-over a rotation of the
blocks), for checking the ring on one device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_lse
from msvit_tpu_torch.parallel.collectives import ModelParallel, _all_gather


def ring_block_forward(q, k, v, mask, o, lse, scale):
    """One ring step: merge the attention of q ``[b, H, n, dh]`` to one
    key/value block (``[b, n_k, H, dh]``, key mask ``[b, n_k]`` or None)
    into the running (o ``[b, H, n, dh]`` f32, updated in place, and lse
    ``[b, H, n]`` f32).  Returns (o, lse)."""
    m4 = None if mask is None else mask[:, None, None, :]
    o_t, lse_t = flash_attention_lse(q, k.transpose(1, 2), v.transpose(1, 2), m4, scale)
    if mask is not None:  # a block with no key to attend adds nothing
        lse_t = torch.where(mask.any(-1)[:, None, None], lse_t, float("-inf"))
    new = torch.logaddexp(lse, lse_t)
    live = new > float("-inf")
    a = torch.where(live, torch.exp(lse - new), 0.0)[..., None]
    b = torch.where(live, torch.exp(lse_t - new), 0.0)[..., None]
    return o.mul_(a).addcmul_(o_t, b), new


def ring_block_backward(q, k, v, mask, out, g, lse, scale):
    """One backward step (K6): (dq, dk, dv) of one block, from the global
    out and lse (``[b, H, n, dh]``, ``[b, H, n]``; a query with no key has
    lse +inf here: p = 0).  k, v ``[b, n_k, H, dh]``; dk, dv come back in
    that layout."""
    m4 = None if mask is None else mask[:, None, None, :]
    dq, dk, dv = flash_attention_bwd(q, k.transpose(1, 2), v.transpose(1, 2), out, g,
                                     lse, m4, scale)
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def _ring_pass(mp: ModelParallel, tensors: List[Optional[torch.Tensor]]):
    """Post the sends of `tensors` to the next rank and the receives of
    the previous rank's into new buffers; returns (requests, buffers)."""
    nxt, prev = (mp.rank + 1) % mp.size, (mp.rank - 1) % mp.size
    ops, bufs = [], []
    for t in tensors:
        if t is None:
            bufs.append(None)
            continue
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dist.get_global_rank(mp.group, nxt), mp.group),
                dist.P2POp(dist.irecv, buf, dist.get_global_rank(mp.group, prev), mp.group)]
        bufs.append(buf)
    return dist.batch_isend_irecv(ops), bufs


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


class _GroupRing:
    """The ring over a "model" group: this process holds one rank's blocks,
    and the next rank's arrive by `batch_isend_irecv`."""

    local = 1

    def __init__(self, mp: ModelParallel):
        self.mp, self.size = mp, mp.size

    def send(self, blocks):
        """Post the hand-over of `blocks` (one list of tensors for each rank
        this process holds); returns the wait that gives the blocks received."""
        reqs, bufs = _ring_pass(self.mp, blocks[0])

        def arrive():
            _wait(reqs)
            return [bufs]

        return arrive


class _LocalRing:
    """Every rank of a ring of `size` in one process (one device): rank r
    holds the r-th token block, and a hand-over rotates the ranks' blocks."""

    def __init__(self, size: int):
        self.size = self.local = size

    def send(self, blocks):
        return lambda: blocks[-1:] + blocks[:-1]


class RingAttentionFunction(torch.autograd.Function):
    """The ring: forward K7-lse per step, backward K6 per step (see the
    module's docstring).  q, k, v ``[b, L*n, H, dh]`` and the mask
    ``[b, L*n]`` hold the blocks of the ``L = ring.local`` ranks this process
    holds, in rank order."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ring, scale):
        qs = [x.transpose(1, 2) for x in q.chunk(ring.local, 1)]
        b, h, n, dh = qs[0].shape
        o = [torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device) for _ in qs]
        lse = [torch.full((b, h, n), float("-inf"), dtype=torch.float32, device=q.device)
               for _ in qs]
        blk = _blocks(k, v, mask, ring.local)
        for t in range(ring.size):
            arrive = ring.send(blk) if t < ring.size - 1 else None
            for r, qt in enumerate(qs):
                o[r], lse[r] = ring_block_forward(qt, *blk[r], o[r], lse[r], scale)
            blk = arrive() if arrive else None
        out = torch.cat([x.to(q.dtype).transpose(1, 2) for x in o], 1).contiguous()
        ctx.save_for_backward(q, k, v, mask, out, torch.cat(lse, 2))
        ctx.ring, ctx.scale = ring, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        local = ring.local
        qs, outs, gs = ([x.transpose(1, 2) for x in t.chunk(local, 1)] for t in (q, out, g))
        lses = torch.where(lse == float("-inf"), float("inf"), lse).chunk(local, 2)
        dq = [torch.zeros(x.transpose(1, 2).shape, dtype=torch.float32, device=q.device)
              for x in qs]
        blk = _blocks(k, v, mask, local)
        dkv = [[torch.zeros(x.shape, dtype=torch.float32, device=k.device) for x in bl[:2]]
               for bl in blk]
        for t in range(ring.size):
            for r in range(local):
                dq_t, dk_t, dv_t = ring_block_backward(qs[r], *blk[r], outs[r], gs[r],
                                                       lses[r], scale)
                dq[r] += dq_t.transpose(1, 2).float()
                dkv[r][0] += dk_t.float()
                dkv[r][1] += dv_t.float()
            if ring.size > 1:  # the last hop takes dk, dv home alone
                last = t == ring.size - 1
                moved = ring.send([([None] * 3 if last else bl) + d
                                   for bl, d in zip(blk, dkv)])()
                blk, dkv = [m[:3] for m in moved], [m[3:] for m in moved]
        return (torch.cat(dq, 1).to(q.dtype),
                torch.cat([d[0] for d in dkv], 1).to(k.dtype),
                torch.cat([d[1] for d in dkv], 1).to(v.dtype), None, None, None)


def _blocks(k, v, mask, local: int):
    """[k, v, mask] of each of the `local` ranks (mask None or [b, n])."""
    ms = [None] * local if mask is None else mask.chunk(local, 1)
    return [[a.contiguous(), b.contiguous(), None if m is None else m.contiguous()]
            for a, b, m in zip(k.chunk(local, 1), v.chunk(local, 1), ms)]


def ring_attention_local(q, k, v, mp: ModelParallel,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Each rank's blocks ``[b, n, H, dh]`` (mask ``[b, n]`` bool) ->
    its queries' output ``[b, n, H, dh]``, exact over all s*n keys."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = None if key_padding_mask is None else key_padding_mask.to(torch.bool)
    return RingAttentionFunction.apply(q, k, v, mask, _GroupRing(mp), float(scale))


class _Scatter(torch.autograd.Function):
    """Whole tensor on every rank -> this rank's [batch, token] block;
    backward gathers the blocks' gradients (the sum over the ranks' parts)."""

    @staticmethod
    def forward(ctx, x, data, model):
        ctx.data, ctx.model = data, model
        bs, ns = x.shape[0] // data.size, x.shape[1] // model.size
        return x.narrow(0, data.rank * bs, bs).narrow(1, model.rank * ns, ns).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(_all_gather(g, ctx.model, 1), ctx.data, 0), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data, model):
        ctx.data, ctx.model = data, model
        return _all_gather(_all_gather(x, model, 1), data, 0)

    @staticmethod
    def backward(ctx, g):
        data, model = ctx.data, ctx.model
        bs, ns = g.shape[0] // data.size, g.shape[1] // model.size
        return g.narrow(0, data.rank * bs, bs).narrow(1, model.rank * ns, ns), None, None


def _axis(mesh: DeviceMesh, name: Optional[str]) -> ModelParallel:
    if name is None:
        return ModelParallel(None, 1, 0)
    return ModelParallel(mesh.get_group(name), mesh[name].size(), mesh.get_local_rank(name))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    key_padding_mask: Optional[torch.Tensor] = None,
    batch_axis: Optional[str] = "data",
    axis_name: str = "model",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact softmax(q k^T / sqrt(dh)) v with the tokens sharded on
    `axis_name` (and the batch on `batch_axis`, if given).  q, k, v
    ``[B, N, H, dh]`` whole on every rank; N must divide by the axis size.
    Returns ``[B, N, H, dh]``, whole on every rank."""
    b, n = q.shape[:2]
    s = mesh[axis_name].size()
    if n % s:
        raise ValueError(f"token count {n} not divisible by mesh axis "
                         f"{axis_name}={s}; pad to a multiple")
    data, model = _axis(mesh, batch_axis), _axis(mesh, axis_name)
    if b % data.size:
        raise ValueError(f"batch {b} not divisible by mesh axis {batch_axis}={data.size}")
    parts = [_Scatter.apply(t, data, model) for t in (q, k, v)]
    mask = None
    if key_padding_mask is not None:
        bs, ns = b // data.size, n // s
        mask = key_padding_mask.narrow(0, data.rank * bs, bs).narrow(1, model.rank * ns, ns)
    return _Gather.apply(ring_attention_local(*parts, model, mask, scale), data, model)


def ring_attention_single_process(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    s: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    g: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]:
    """Every rank of a ring of s in one process: `RingAttentionFunction`,
    the loop the ranks run, with the hand-over a rotation of the ranks'
    blocks; with a cotangent `g` its backward gives (dq, dk, dv).  Inputs
    ``[B, N, H, dh]``, N divisible by s.  Returns (out, grads or None)."""
    n, dh = q.shape[1], q.shape[-1]
    if n % s:
        raise ValueError(f"token count {n} not divisible by {s} blocks")
    if scale is None:
        scale = dh ** -0.5
    mask = None if key_padding_mask is None else key_padding_mask.to(torch.bool)
    if g is None:
        return RingAttentionFunction.apply(q, k, v, mask, _LocalRing(s), float(scale)), None
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = RingAttentionFunction.apply(*leaves, mask, _LocalRing(s), float(scale))
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads
