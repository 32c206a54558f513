"""Sharded training steps (counterpart of `msvit_tpu/parallel/train_step.py`).

`make_sharded_train_step` runs the port's own `Optimizer` (AdamW) on a
model sharded over a ("data", "model") mesh.  Each rank feeds its own part
of the batch (its "data" index's share; the ranks of one "model" group feed
the same examples), and `loss_fn` returns the mean over what it was fed.
Three modes:

* data parallel (the default): gradients averaged over "data" (one
  all-reduce of a flat buffer per dtype; none in a group of one);
* ``zero1``: ZeRO stage 1.  Each data rank keeps AdamW's moments for its
  1/dp slice of each parameter only, on the largest axis that dp divides
  and that tensor parallelism does not already shard (JAX's `_zero1_spec`);
  a tensor with no such axis keeps whole moments on every rank.  The
  gradients are reduce-scattered into the slices (one flat buffer per
  dtype; a sliced parameter's own `.grad` is dropped), the rank updates
  its slice, then the slices are all-gathered into the parameter: two
  passes of the parameters' bytes, as JAX's reduce-scatter and all-gather.
  At dp = 1 nothing is sliced and the step is the data-parallel one;
* ``fsdp``: the parameters themselves are sharded over "data" on top of
  the tensor-parallel shards: `torch.distributed.fsdp.fully_shard` on every
  block and on the model, over the mesh's "data" axis (it gathers a
  block's weights before its forward and backward and reduce-scatters its
  gradients); gradients and moments inherit the sharding, so ``zero1`` is
  subsumed.  The fused AdamW runs on the `DTensor` parameters; with a bf16
  first moment (``mu_dtype``) the port's own update runs on each rank's
  local shards (`train/loop.py::local_tensor`), its moments the shards'
  size.

Under tensor parallelism the gradients that each "model" rank holds in part
(`ParallelInfo.partial_grads`) are summed over "model" first.  A gradient
clip or the non-finite skip reads the global norm over every shard, as the
unsharded step's.  The loss returned is the mean over "data".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from msvit_tpu_torch.parallel.collectives import ModelParallel, _all_gather
from msvit_tpu_torch.parallel.sharding import (
    ParallelInfo, all_reduce_flat, parallelize, sum_partial_grads)
from msvit_tpu_torch.train.loop import LossFn, Optimizer, OptState, local_tensor


def zero1_axis(shape, data_size: int, exclude: Optional[int] = None) -> Optional[int]:
    """The axis a ZeRO-1 moment is split on: the largest axis that
    `data_size` divides, other than `exclude` (the tensor-parallel axis);
    None where there is none, and for a group of one (JAX's `_zero1_spec`)."""
    if data_size == 1:
        return None
    best = None
    for i, n in enumerate(shape):
        if i != exclude and n > 0 and n % data_size == 0:
            if best is None or n > shape[best]:
                best = i
    return best


class Zero1State:
    """AdamW state over this data rank's slices of the parameters (ZeRO-1):
    the port's `OptState` over the slices, the reduce-scatter of the
    gradients into them and the all-gather that writes the updated slices
    back into the parameters.  A slice on a parameter's first axis is a view
    of it; another axis's is a copy, since the fused AdamW takes contiguous
    tensors only."""

    def __init__(self, spec: Optimizer, model: nn.Module, mesh: DeviceMesh,
                 info: ParallelInfo):
        self.spec = spec
        self.dp = mesh["data"].size()
        self.rank = mesh.get_local_rank("data")
        self.data = ModelParallel(mesh.get_group("data"), self.dp, self.rank)
        # (parameter, axis or None, its slice, a "model" shard) of every
        # parameter that takes a gradient; only the trainable are sliced
        self.entries = []
        named = []
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            trainable = spec.trainable is None or spec.trainable(tuple(name.split(".")))
            tp_spec = info.specs.get(name)
            axis = zero1_axis(p.shape, self.dp, None if tp_spec is None else tp_spec.dim) \
                if trainable else None
            part = p
            if axis is not None:
                view = p.detach().chunk(self.dp, axis)[self.rank]
                part = nn.Parameter(view if view.is_contiguous() else view.clone())
            self.entries.append((p, axis, part, tp_spec is not None))
            if trainable:
                named.append((name, part))
        self.inner = OptState(spec, named)

    def reduce_grads(self) -> List[Tuple[torch.Tensor, bool, bool]]:
        """Average the gradients over "data": the sliced ones reduce-scattered
        into their slices' `.grad`, the rest all-reduced in place.  Returns
        (the gradient the update reads, a "data" slice, a "model" shard) for
        each parameter that has one."""
        for p, axis, part, _ in self.entries:
            if axis is not None:
                part.grad = None  # a parameter without a gradient this step
        held = [e for e in self.entries if e[0].grad is not None]
        all_reduce_flat([p.grad for p, axis, _, _ in held if axis is None], self.data.group,
                        1.0 / self.dp)
        by_dtype: Dict[torch.dtype, list] = {}
        for e in held:
            if e[1] is not None:
                by_dtype.setdefault(e[0].grad.dtype, []).append(e)
        for es in by_dtype.values():
            # row r of [dp, total]: every gradient's r-th slice, flattened
            flat = torch.cat([p.grad.movedim(axis, 0).reshape(self.dp, -1)
                              for p, axis, _, _ in es], 1)
            mine = flat.new_empty(flat.shape[1])
            dist.reduce_scatter_tensor(mine, flat.view(-1), group=self.data.group)
            mine.mul_(1.0 / self.dp)
            for (p, axis, part, _), piece in zip(es, mine.split([e[2].numel() for e in es])):
                part.grad = piece.view(part.movedim(axis, 0).shape).movedim(0, axis).contiguous()
                p.grad = None
        return [(p.grad if axis is None else part.grad, axis is not None, tp)
                for p, axis, part, tp in held]

    def update(self, grads_finite: Optional[torch.Tensor]) -> None:
        self.inner.update(grads_finite)
        with torch.no_grad():
            for p, axis, part, _ in self.entries:
                if axis is not None:
                    p.copy_(_all_gather(part.detach(), self.data, axis))

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state)


def make_sharded_train_step(
    loss_fn: LossFn,
    optimizer: Optimizer,
    mesh: DeviceMesh,
    model: nn.Module,
    zero1: bool = False,
    fsdp: bool = False,
) -> Tuple[Callable[[nn.Module, Any, torch.Generator], Tuple[torch.Tensor, Any]], Any]:
    """Shard `model` in place (`parallelize`; with `fsdp` also
    `fully_shard` over "data") and build ``(step, opt_state)``:
    ``step(model, opt_state, batch, generator) -> (loss, aux)``, loss the
    detached mean over "data".  `loss_fn(model, batch, generator) -> (mean
    loss over the rank's batch, aux)`."""
    info = parallelize(model, mesh)
    data_group, dp = mesh.get_group("data"), mesh["data"].size()
    model_group = mesh.get_group("model")
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        from msvit_tpu_torch.models.base.model import BaseViTLayer

        for m in model.modules():
            if isinstance(m, BaseViTLayer):
                fully_shard(m, mesh=mesh["data"])
        fully_shard(model, mesh=mesh["data"])
        zero1 = False  # the moments inherit the parameters' sharding
    opt_state = Zero1State(optimizer, model, mesh, info) if zero1 else optimizer.init(model)
    tp_names = set(info.specs)

    def step(model, opt_state, batch, generator):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        for _, p in named:
            p.grad = None
        loss, aux = loss_fn(model, batch, generator)
        loss.backward()
        sum_partial_grads(model)
        # (the gradient the update reads, a "data" slice, a "model" shard)
        if zero1:
            grads = opt_state.reduce_grads()
        else:
            grads = [(local_tensor(p.grad), fsdp, n in tp_names) for n, p in named
                     if p.grad is not None]
            if not fsdp:  # fully_shard averages over "data" itself
                all_reduce_flat([g for g, _, _ in grads], data_group, 1.0 / dp)
        finite = None
        if optimizer.clip_norm or optimizer.max_nonfinite is not None:
            # sums of squares: [whole on every data rank, a "data" slice] x
            # [replicated on "model", a "model" shard]
            sq = torch.zeros(2, 2, device=grads[0][0].device)
            for g, sliced, shard in grads:
                sq[int(sliced), int(shard)] += g.float().square().sum()
            sliced_sq = sq[1].clone()
            dist.all_reduce(sliced_sq, group=data_group)  # each rank's slices
            tp_sq = sq[0, 1] + sliced_sq[1]
            dist.all_reduce(tp_sq, group=model_group)  # each rank's heads/units
            norm = (sq[0, 0] + sliced_sq[0] + tp_sq).sqrt()
            finite = torch.isfinite(norm)
            if optimizer.clip_norm:
                torch._foreach_mul_([g for g, _, _ in grads],
                                    optimizer.clip_norm / norm.clamp_min(optimizer.clip_norm))
        opt_state.update(finite)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=data_group)
        return loss / dp, aux

    return step, opt_state
