"""Multi-process glue (counterpart of `msvit_tpu/parallel/distributed.py`).

One process per card.  `initialize` starts the default process group from
the environment a launcher sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as `torchrun` does) or from explicit arguments, and is a
no-op without either, so one training script runs unchanged on one card and
under a launcher.  Nothing on a machine tells a program of a cluster: the
address, world size and rank come from the caller.

Typical setup:

    from msvit_tpu_torch.parallel import distributed as dist
    dist.initialize()                         # no-op in a single process
    shard_i, shard_n = dist.host_shard()
    sampler = IndexSampler(..., shard_index=shard_i, shard_count=shard_n)
    mesh = make_mesh(tp=...)
    batch = dist.global_batch(mesh, local_batch)   # rank-local -> DTensor

Every rank feeds only its own examples: `IndexSampler` derives each
shard's slice from the same Feistel order, so the union is one epoch.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from msvit_tpu_torch.parallel.mesh import TIMEOUT

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> None:
    """`torch.distributed.init_process_group` with an explicit timeout.

    With `init_method` (``tcp://host:port`` or ``file://path``), world size
    and rank given, those are used; otherwise the launcher's environment
    (``env://``).  A no-op when a group exists, or when neither arguments
    nor the environment are there.  `backend` defaults to NCCL, which needs
    a card; pass "gloo" to run on the CPU."""
    if dist.is_initialized():
        return
    if init_method is None:
        if not all(k in os.environ for k in _ENV):
            return  # a single process: nothing to join
        init_method = "env://"
    if backend is None:
        backend = "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: NCCL needs a CUDA device; pass backend='gloo' "
                           "to run on the CPU")
    kwargs = {}
    if backend == "nccl":
        rank_now = rank if rank is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank_now % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout, **kwargs)


def host_shard() -> Tuple[int, int]:
    """(shard_index, shard_count) for input sharding: feed it to
    `data.resumable.IndexSampler` so each rank reads a disjoint slice of
    the same global epoch order.  (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_batch_size(global_batch_size: int) -> int:
    """Per-rank batch size for an evenly sharded global batch."""
    n = host_shard()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def global_batch(mesh: DeviceMesh, local_batch: Any, dim: str = "data") -> Any:
    """Wrap each rank's local tensors as one logically global `DTensor`,
    its batch axis sharded on `dim` (replicated on the mesh's other axes);
    no data moves.  Works on dicts, lists and tuples of tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(0) if name == dim else Replicate() for name in mesh.mesh_dim_names]

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        return DTensor.from_local(torch.as_tensor(x), mesh, placements, run_check=False)

    return one(local_batch)
