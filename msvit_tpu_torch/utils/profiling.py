"""Tracing and block timers (counterpart of `msvit_tpu/utils/profiling.py`,
`torch.profiler` where the JAX package has `jax.profiler`)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host and card trace into `log_dir` (a TensorBoard
    trace-handler directory; the card's activities when there is one):

        with profiling.trace("/tmp/trace") as prof:
            step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class BlockTimer:
    """Named block timers with running means.  With a `device` (a CUDA
    device, or a tensor on one) each block synchronises that device before
    it reads the clock at its start and at its end, so the block's card
    work is in its time."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @staticmethod
    def _sync(device) -> None:
        if isinstance(device, torch.Tensor):
            device = device.device
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def __call__(self, name: str, device: Optional[object] = None) -> Iterator[None]:
        self._sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync(device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in sorted(self.totals)}
