"""Pipeline parallelism, GPipe over a "stage" group (counterpart of
`msvit_tpu/parallel/pipeline.py`).

The trunk's layers are split into S contiguous stages; rank s of the
"stage" group holds layers ``[s*L/S, (s+1)*L/S)`` as an `nn.ModuleList`
(no stacking: the port has no scanned trunk).  `gpipe` runs JAX's padded
schedule, one program on every rank: S + M - 1 ticks; at tick t stage s
works on microbatch t - s when that is one of the M, and then every rank
hands its output to the next stage (`batch_isend_irecv`).  The last stage's
outputs are summed onto every rank (JAX's `psum`), so the result is whole
everywhere.

The backward is autograd's: the hand-over is a `torch.autograd.Function`
whose backward sends the gradient back a stage, and every rank builds the
same graph (stage 0 keeps the received buffer in it through a `where`, an
idle tick passes ``0 * input``), so every rank runs the hand-overs'
backwards in the same order, tick S + M - 2 down to 0.  The input reaches
stage 0 only, so its gradient is summed over the stages
(`copy_to_model` on the stage group): layers before the pipeline that every
rank computes (the embeddings) get their whole gradient on every rank.
One mean loss over the batch gives the full-batch mean gradient, as JAX's
``jnp.mean`` loss: nothing is scaled per microbatch.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from msvit_tpu_torch.parallel.collectives import ModelParallel, copy_to_model
from msvit_tpu_torch.parallel.mesh import (
    backend_for, cached_mesh, ensure_process_group, group_options)


def make_stage_mesh(num_stages: Optional[int] = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ("stage",) mesh over the default group's ranks (all of them
    when `num_stages` is None)."""
    backend = backend_for(device_type)
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if num_stages not in (None, n):
        raise ValueError(f"{num_stages} stages on {n} ranks")
    return cached_mesh(("stage", n, device_type), lambda: init_device_mesh(
        device_type, (n,), mesh_dim_names=("stage",),
        backend_override={"stage": group_options(backend)}))


def _stage_axis(mesh: DeviceMesh, name: str) -> ModelParallel:
    return ModelParallel(mesh.get_group(name), mesh[name].size(), mesh.get_local_rank(name))


def split_layers_into_stages(encoder_state: Mapping[str, torch.Tensor],
                             num_stages: int) -> List[Dict[str, torch.Tensor]]:
    """An encoder's state dict (``layer.<i>.<name>``) -> one state dict per
    stage for an `nn.ModuleList` of its L/S layers (``<j>.<name>``)."""
    layers = sorted({int(m.group(1)) for k in encoder_state
                     if (m := re.match(r"layer\.(\d+)\.", k))})
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"{n} layers not divisible by {num_stages} stages")
    per = n // num_stages
    stages: List[Dict[str, torch.Tensor]] = [{} for _ in range(num_stages)]
    for k, v in encoder_state.items():
        m = re.match(r"layer\.(\d+)\.(.*)", k)
        if m:
            i = int(m.group(1))
            stages[i // per][f"{i % per}.{m.group(2)}"] = v
    return stages


class _HandOver(torch.autograd.Function):
    """Forward: send to the next stage, receive from the previous one
    (zeros at stage 0).  Backward: the reverse, for the gradient."""

    @staticmethod
    def forward(ctx, x, st):
        ctx.st = st
        return _shift(x.detach().contiguous(), st, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.st, -1), None


def _shift(x: torch.Tensor, st: ModelParallel, step: int) -> torch.Tensor:
    """x sent `step` stages on (no wrap); what arrives from the other side
    (zeros where nothing does)."""
    out = torch.zeros_like(x)
    to, frm = st.rank + step, st.rank - step
    ops = []
    if 0 <= to < st.size:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(st.group, to), st.group))
    if 0 <= frm < st.size:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(st.group, frm), st.group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return out


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (a sum in which the other
    stages give zeros); backward: the gradient to the last stage only."""

    @staticmethod
    def forward(ctx, x, st):
        ctx.last = st.rank == st.size - 1
        y = x if ctx.last else torch.zeros_like(x)
        y = y.contiguous().clone()
        dist.all_reduce(y, group=st.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def gpipe(
    stage_fn: Callable[..., torch.Tensor],
    num_stages: int,
    num_microbatches: int,
    mesh: DeviceMesh,
    stage_axis: str = "stage",
):
    """Build ``run(x_mb, extras_mb=None)``: x_mb ``[M, mb, ...]``, the
    microbatched input (read by stage 0); extras_mb an optional dict of
    per-microbatch side inputs with leading axis [M] (attention masks) that
    the stages do not transform: each stage reads the entry of the
    microbatch it is working on and calls ``stage_fn(x, extras)``.  Returns
    ``[M, mb, ...]``, the last stage's outputs, on every rank.  Each stage's
    output has the input's shape."""
    st_total, m_total = num_stages, num_microbatches

    def run(x_mb: torch.Tensor, extras_mb: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        st = _stage_axis(mesh, stage_axis)
        if st.size != st_total:
            raise ValueError(f"mesh axis {stage_axis} has {st.size} ranks, not {st_total}")
        s = st.rank
        grad = torch.is_grad_enabled()
        if grad and x_mb.requires_grad:
            x_mb = copy_to_model(x_mb, st)
        # a leaf that needs grad: every rank's hand-overs enter the graph
        buf = torch.zeros_like(x_mb[0]).requires_grad_(grad)
        first = torch.tensor(s == 0, device=x_mb.device)
        outputs = []
        for t in range(st_total + m_total - 1):
            inp = torch.where(first, x_mb[min(t, m_total - 1)], buf)
            mb = t - s
            if 0 <= mb < m_total:
                if extras_mb is None:
                    out = stage_fn(inp)
                else:
                    out = stage_fn(inp, {k: v[mb] for k, v in extras_mb.items()})
            else:  # idle tick: keep the hand-over chain in the graph
                out = inp * 0
            if t >= st_total - 1:
                outputs.append(out)
            if t < st_total + m_total - 2:
                buf = _HandOver.apply(out, st)
        return _FromLast.apply(torch.stack(outputs), st)

    return run


def make_layer_stage_fn(layers: nn.ModuleList):
    """stage_fn for a stage's layers: runs them in order; the optional
    ``extras`` may carry an "attention_mask" handed to every layer."""

    def stage_fn(x, extras=None):
        mask = None if extras is None else extras.get("attention_mask")
        for layer in layers:
            x, _ = layer(x, None, mask)
        return x

    return stage_fn
