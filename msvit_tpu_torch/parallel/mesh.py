"""Mesh construction (counterpart of `msvit_tpu/parallel/mesh.py`).

A ``("data", "model")`` `DeviceMesh` over the ranks of the default process
group, built by `init_device_mesh`:

* "data": data parallel (the batch is split over it);
* "model": tensor parallel (attention heads, MLP hidden, experts) and,
  with ``config.sequence_sharding``, the token axis between blocks.

Ranks are laid out row-major, rank = data_index * tp + model_index, so
"model" is the fast axis, as JAX's ``np.reshape(devices, (dp, tp))``.
Every process group is created with an explicit timeout (`TIMEOUT`): a
collective that never completes raises instead of hanging.

The device defaults to "cuda" (NCCL); without a card `make_mesh` raises.
Only an explicit ``device_type="cpu"`` runs on the CPU (gloo), which is
what the tests pass.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TIMEOUT = datetime.timedelta(seconds=300)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The collective backend of `device_type`; raises for "cuda" without
    a card (there is no fallback to the CPU)."""
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r} is not one of {tuple(_BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' "
                           "(gloo) to run on the CPU")
    return _BACKENDS[device_type]


def group_options(backend: str, timeout: datetime.timedelta = TIMEOUT):
    """(backend, options) carrying `timeout`, for `init_device_mesh`'s
    ``backend_override`` (the sub-groups it makes otherwise take the
    backend's default timeout, 10-30 minutes)."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    else:
        opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    return backend, opts


def ensure_process_group(device_type: str = "cuda") -> None:
    """A single-process default group (a file store in a temporary
    directory) when none exists, so that one script runs unchanged on one
    card and under a launcher."""
    backend = backend_for(device_type)
    if dist.is_initialized():
        return
    from msvit_tpu_torch.parallel.distributed import initialize

    store = os.path.join(tempfile.mkdtemp(prefix="msvit_dist_"), "store")
    initialize(init_method=f"file://{store}", world_size=1, rank=0, backend=backend)


# the meshes built over `_MESH_GROUP`, the default group they were built
# for (held, so that its id is never another group's while it is compared)
_MESHES: Dict[tuple, DeviceMesh] = {}
_MESH_GROUP: List[Optional[dist.ProcessGroup]] = [None]


def cached_mesh(key: tuple, build) -> DeviceMesh:
    """The mesh of `key` for the current default group, built once: its
    sub-groups live as long as the default group, and making them again
    costs a round of the store per group.  A new default group (after
    `destroy_process_group`, whose meshes' sub-groups are gone) empties
    the cache."""
    group = dist.distributed_c10d._get_default_group()
    if _MESH_GROUP[0] is not group:
        _MESHES.clear()
        _MESH_GROUP[0] = group
    if key not in _MESHES:
        _MESHES[key] = build()
    return _MESHES[key]


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a ("data", "model") mesh over the default group's ranks (once
    per shape and default group).  dp defaults to world // tp."""
    backend = backend_for(device_type)
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != {n} devices")
    opts = group_options(backend)
    return cached_mesh(("data", "model", dp, tp, device_type), lambda: init_device_mesh(
        device_type, (dp, tp), mesh_dim_names=("data", "model"),
        backend_override={"data": opts, "model": opts}))
