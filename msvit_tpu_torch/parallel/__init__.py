"""The parallel layer (counterpart of `msvit_tpu/parallel`), on
`torch.distributed`.

The JAX package states sharding as `PartitionSpec`s and lets GSPMD insert
the collectives.  Here the trunk computes on each rank's local shards (the
attention kernels take plain tensors, not DTensors) and the collectives are
explicit: the Megatron f/g pairs (`collectives.py`), a flat all-reduce or a
ZeRO-1 all-gather in the train step, `fully_shard` for FSDP, point-to-point
rings for ring attention and GPipe.  Meshes are `DeviceMesh`es; a batch
becomes a global `DTensor` (`distributed.global_batch`).

Entry points default to the card (NCCL) and raise without one; only an
explicit ``device_type="cpu"`` / ``backend="gloo"`` runs on the CPU.

The names below load on first use: the trunk imports `collectives` from
this package, and `pipeline_vit` imports the trunk.
"""

import importlib

_NAMES = {
    "make_mesh": "mesh",
    "init_pipelined_classifier": "pipeline_vit",
    "make_pipelined_classifier_apply": "pipeline_vit",
    "make_pipelined_loss_fn": "pipeline_vit",
    "pipeline_params_from_full": "pipeline_vit",
    "shard_pipeline_params": "pipeline_vit",
    "ring_attention": "ring_attention",
    "partition_spec_for_params": "sharding",
    "shard_params": "sharding",
    "parallelize": "sharding",
    "make_sharded_train_step": "train_step",
    "distributed": None,
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_NAMES[name] or name}")
    return module if _NAMES[name] is None else getattr(module, name)


