"""Tensor-parallel rules on the port's parameter names (counterpart of
`msvit_tpu/parallel/sharding.py`).

The port keeps torch's ``[out, in]`` layout, so the rules are stated on its
state-dict names.  A rule is a `TPShard`: view axis `dim` as ``[groups,
-1]`` and give each "model" rank its contiguous part of the second axis.
`groups` keeps a fused weight's sections apart:

* ``attention.qkv.weight`` ``[3*H*dh, D]`` (rows q|k|v, head, e), its bias
  and the ``qscale`` buffer: the head axis of the ``[3, H*dh]`` view, so a
  rank holds q, k and v of H/tp heads, the packed layout the kernels take
  at H/tp heads (a contiguous row split would hand rank 0 all of q);
* ``attention.output_dense.weight`` ``[D, H*dh]``: dim 1 (row parallel);
* ``mlp.fc1`` weight ``[F, D]`` and bias: dim 0; ``mlp.fc2.weight``: dim 1;
* SwiGLU ``mlp.weights_in`` ``[2h, D]`` and bias: the ``h`` axis of the
  ``[2, h]`` view (a contiguous split hands a rank only gate rows);
  ``mlp.weights_out.weight``: dim 1;
* MoE ``experts_in`` ``[E, D, F]``, ``experts_out`` ``[E, F, D]`` and their
  biases: the expert axis;
* everything else (LayerNorms, layer scales, embeddings, heads, the router,
  biases of row-parallel layers): replicated (None).  A row-parallel
  layer's bias is added once, after the reduction.

`parallelize` shards a built model in place and gives its attention, MLP
and MoE modules the mesh's "model" group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from msvit_tpu_torch.parallel.collectives import ModelParallel


@dataclasses.dataclass(frozen=True)
class TPShard:
    """Shard axis `dim` of a tensor viewed as ``[groups, -1]`` on "model"."""

    dim: int
    groups: int = 1


_COLUMN = {"fc1": TPShard(0), "weights_in": TPShard(0, 2)}


def partition_spec_for_params(path: Sequence[str],
                              tensor: Optional[torch.Tensor] = None) -> Optional[TPShard]:
    """The rule of a parameter (or the ``qscale`` buffer) from its name
    split at "." (the tensor is not read); None: replicated."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if parent == "qkv" and name in ("weight", "bias"):
        return TPShard(0, 3)
    if name == "qscale":
        return TPShard(0, 3)
    if parent == "output_dense" and name == "weight":
        return TPShard(1)
    if parent in _COLUMN and name in ("weight", "bias"):
        return _COLUMN[parent]
    if parent in ("fc2", "weights_out") and name == "weight":
        return TPShard(1)
    if name in ("experts_in", "experts_out", "experts_in_bias", "experts_out_bias"):
        return TPShard(0)
    return None


def local_shard(t: torch.Tensor, spec: Optional[TPShard], rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s part of `t` under `spec` (a copy; `t` itself when
    replicated)."""
    if spec is None:
        return t
    view = t.unflatten(spec.dim, (spec.groups, -1))
    if view.shape[spec.dim + 1] % size:
        raise ValueError(f"axis of {view.shape[spec.dim + 1]} not divisible by tp={size}")
    part = view.chunk(size, spec.dim + 1)[rank]
    return part.flatten(spec.dim, spec.dim + 1).contiguous()


def check_tp(config, tp: int) -> None:
    """Raise `ValueError`, naming the field, where `tp` does not divide what
    it shards: heads (a pruned trunk's H' too), the MLP's or SwiGLU's hidden
    units, or the experts."""
    sizes = {"num_attention_heads": config.num_attention_heads}
    if config.num_experts > 0:
        sizes["num_experts"] = config.num_experts
    elif config.use_swiglu_ffn:
        sizes["swiglu_hidden_size"] = config.swiglu_hidden_size
    else:
        sizes["mlp_hidden_size"] = config.mlp_hidden_size
    for field, n in sizes.items():
        if n % tp:
            raise ValueError(f"{field}={n} is not divisible by tp={tp}")


def _tp_modules():
    from msvit_tpu_torch.models.base.model import (
        BaseMLP, BaseSwiGLUFFN, BaseViTSelfAttention)
    from msvit_tpu_torch.models.base.moe import MoEFFN

    return (BaseViTSelfAttention, BaseMLP, BaseSwiGLUFFN, MoEFFN)


@dataclasses.dataclass
class ParallelInfo:
    """What `parallelize` did to a model: the mesh, each sharded tensor's
    rule by state-dict name, and the replicated parameters whose gradient
    each "model" rank holds only in part (they are summed over "model" by
    the train step): qk-norm scales (each rank sees its heads) and, under
    sequence sharding, the block's parameters that act on sharded tokens."""

    mesh: DeviceMesh
    specs: Dict[str, TPShard]
    partial_grads: List[str]


def parallelize(model: nn.Module, mesh: DeviceMesh) -> ParallelInfo:
    """Shard `model` in place on the mesh's "model" axis and give its
    attention, MLP and MoE modules the group (also at tp = 1, where every
    collective is the identity).  Encoders whose config sets
    ``sequence_sharding`` split their tokens on the group between blocks.
    Weights must be equal on every rank first (drawn from one seed, or
    loaded).  Returns the `ParallelInfo`, also kept as
    ``model.msvit_parallel``."""
    from msvit_tpu_torch.models.base.model import BaseViTEncoder

    tp, rank = mesh["model"].size(), mesh.get_local_rank("model")
    group = mesh.get_group("model")
    kinds = _tp_modules()
    modules = dict(model.named_modules())
    for m in modules.values():
        if isinstance(m, kinds) and hasattr(m, "config"):  # the MLPs keep none
            check_tp(m.config, tp)
    plain = ModelParallel(group, tp, rank)
    partial: List[str] = []
    for name, m in modules.items():
        if isinstance(m, BaseViTEncoder) and m.config.sequence_sharding:
            m.tp = ModelParallel(group, tp, rank, seq=True)
            for i, layer in enumerate(m.layer):
                layer.attention.tp = layer.mlp.tp = m.tp
                prefix = f"{name}.layer.{i}." if name else f"layer.{i}."
                partial += [prefix + n for n, _ in layer.named_parameters()
                            if partition_spec_for_params(n.split(".")) is None
                            and not n.startswith("mlp.router.")]
    specs: Dict[str, TPShard] = {}
    for name, m in modules.items():
        if not isinstance(m, kinds):
            continue
        if m.tp is None:
            m.tp = plain
        prefix = f"{name}." if name else ""
        for sub_name, sub in m.named_modules():
            owner = prefix + (f"{sub_name}." if sub_name else "")
            for store in (sub._parameters, sub._buffers):
                for key, t in list(store.items()):
                    spec = partition_spec_for_params((owner + key).split("."))
                    if t is None or spec is None:
                        continue
                    local = local_shard(t.detach(), spec, rank, tp)
                    if isinstance(t, nn.Parameter):
                        local = nn.Parameter(local, requires_grad=t.requires_grad)
                    store[key] = local
                    specs[owner + key] = spec
        if hasattr(m, "q_norm"):  # each rank's gradient covers its heads
            partial += [f"{prefix}{n}.weight" for n in ("q_norm", "k_norm")]
    info = ParallelInfo(mesh, specs, sorted(set(partial)))
    model.msvit_parallel = info
    return info


def shard_params(mesh: DeviceMesh, state_dict: Mapping[str, torch.Tensor],
                 config=None) -> Dict[str, torch.Tensor]:
    """Each rank's local tensors of a full state dict (e.g. the converted
    JAX weights, `compat.from_jax`) under the rules, for a model that
    `parallelize` has sharded.  With `config`, indivisible sizes raise."""
    tp, rank = mesh["model"].size(), mesh.get_local_rank("model")
    if config is not None:
        check_tp(config, tp)
    return {k: local_shard(v, partition_spec_for_params(k.split(".")), rank, tp)
            for k, v in state_dict.items()}


def sharded_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state as one global tensor per name for
    `torch.distributed.checkpoint`: a sharded tensor becomes a `DTensor` of
    its rule's view (``[..., groups, n, ...]``, sharded on "model",
    replicated on "data") over this rank's storage; the rest stay plain
    (every rank holds them whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    info: ParallelInfo = model.msvit_parallel
    out = {}
    for name, t in model.state_dict().items():
        spec = info.specs.get(name)
        if spec is None:
            out[name] = t
            continue
        placements = [Shard(spec.dim + 1) if d == "model" else Replicate()
                      for d in info.mesh.mesh_dim_names]
        out[name] = DTensor.from_local(t.unflatten(spec.dim, (spec.groups, -1)),
                                       info.mesh, placements, run_check=False)
    return out


def load_sharded_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Copy a `sharded_state_dict`-shaped state (e.g. restored from a
    checkpoint) back into the model's local tensors."""
    from torch.distributed.tensor import DTensor

    info: ParallelInfo = model.msvit_parallel
    local = {}
    for name, t in state.items():
        if isinstance(t, DTensor):
            t = t.to_local().flatten(info.specs[name].dim, info.specs[name].dim + 1)
        local[name] = t
    model.load_state_dict(local, strict=True)


def full_state_dict(model: nn.Module, grads: bool = False) -> Dict[str, torch.Tensor]:
    """The unsharded state dict on every rank (FSDP's `DTensor`s made whole
    over "data", the tensor-parallel shards gathered over "model"): what
    the model was before `parallelize`, for export or comparison.  With
    `grads`, the parameters' gradients instead, by the same names."""
    from msvit_tpu_torch.parallel.collectives import _all_gather

    info: Optional[ParallelInfo] = getattr(model, "msvit_parallel", None)
    items = ({n: p.grad for n, p in model.named_parameters() if p.grad is not None}
             if grads else model.state_dict())
    out = {}
    for name, t in items.items():
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        spec = None if info is None else info.specs.get(name)
        if spec is not None:
            mesh = info.mesh
            mp = ModelParallel(mesh.get_group("model"), mesh["model"].size(),
                               mesh.get_local_rank("model"))
            view = t.detach().unflatten(spec.dim, (spec.groups, -1))
            t = _all_gather(view, mp, spec.dim + 1).flatten(spec.dim, spec.dim + 1)
        out[name] = t.detach()
    return out


def sum_partial_grads(model: nn.Module) -> None:
    """Sum over "model" the gradients each rank holds in part
    (`ParallelInfo.partial_grads`), in place, through one flat buffer."""
    info: ParallelInfo = model.msvit_parallel
    named = dict(model.named_parameters())
    grads = [named[n].grad for n in info.partial_grads if named[n].grad is not None]
    grads = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    if grads:
        all_reduce_flat(grads, info.mesh.get_group("model"))


def all_reduce_flat(tensors: List[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum `tensors` over `group` in place, through one flat buffer per
    dtype, and multiply by `scale` (a group of one only scales)."""
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        if scale != 1.0 and tensors:
            torch._foreach_mul_(tensors, scale)
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])
