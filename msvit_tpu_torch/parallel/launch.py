"""A pool of CPU ranks for running the parallel layer in one process tree.

`RankPool(n)` starts n processes (spawn), each of which joins one gloo
group (a `file://` store in a temporary directory, the mesh's timeout),
and then runs jobs sent by name: ``pool.run("package.module:function",
**kwargs)`` calls that function on every rank with ``rank`` and ``world``
added to its keyword arguments and returns the ranks' results in rank
order.  A job that raises on any rank raises here with the rank's
traceback; a job that does not return within its time limit stops the pool
and raises `TimeoutError`, so a collective that never completes cannot
hang the caller.  The pool is started once and serves many jobs (a spawn
costs seconds); `close()` stops every process it started.

The ranks import only what the jobs' modules import: the port's tests keep
their rank bodies in modules that import no JAX.
"""

from __future__ import annotations

import datetime
import importlib
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, List, Optional, Sequence

import torch.multiprocessing as mp


def _worker(rank: int, world: int, store: str, timeout_s: float, preload, jobs,
            results) -> None:
    import torch

    torch.set_num_threads(1)  # n ranks share the host's cores
    for mod in preload:
        importlib.import_module(mod)
    from msvit_tpu_torch.parallel.distributed import initialize

    initialize(init_method=f"file://{store}", world_size=world, rank=rank, backend="gloo",
               timeout=datetime.timedelta(seconds=timeout_s))
    import torch.distributed as dist

    while True:
        job = jobs.get()
        if job is None:
            break
        target, kwargs = job
        try:
            mod, fn = target.split(":")
            out = getattr(importlib.import_module(mod), fn)(rank=rank, world=world, **kwargs)
            results.put((rank, True, out))
        except BaseException:  # reported to the caller, which raises
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """n gloo CPU ranks that run jobs by name (see the module docstring)."""

    def __init__(self, n: int, timeout: float = 120.0, preload: Sequence[str] = ()):
        """`preload`: modules each rank imports while it starts (the jobs'
        modules), so that the first job does not pay for them."""
        self.n, self.timeout = n, timeout
        self._dir = tempfile.mkdtemp(prefix="msvit_ranks_")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, n, os.path.join(self._dir, "store"), timeout,
                              tuple(preload), self._jobs[r], self._results))
            for r in range(n)]
        for p in self._procs:
            p.start()
        self._broken: Optional[str] = None

    def run(self, target: str, timeout: Optional[float] = None, **kwargs) -> List[Any]:
        """`target` ("module:function") on every rank; the results in rank
        order."""
        if self._broken:
            raise RuntimeError(f"rank pool stopped after an earlier failure: {self._broken}")
        for q in self._jobs:
            q.put((target, kwargs))
        out, errors = [None] * self.n, []
        for _ in range(self.n):
            try:
                rank, ok, value = self._results.get(timeout=timeout or self.timeout)
            except queue.Empty:
                self._broken = f"{target} timed out"
                self.close()
                raise TimeoutError(f"{target}: no result within {timeout or self.timeout} s")
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            # the other ranks may be stuck in a collective: stop the pool
            self._broken = f"{target} failed"
            self.close()
            raise RuntimeError(f"{target} failed\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
