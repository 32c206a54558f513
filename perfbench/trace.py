"""The device trace of a run's window, and what the readers take from it.

`Tracer` wraps the measured window in `torch.profiler` (host and device
activities) when a run is traced, and does nothing otherwise.  On the H100
the profiler can drop the first launches of a profile and the kernels whose
device timestamps, mapped to the host clock, fall before its start, so the
window sits behind a lead-in: a short host sleep, then small device adds.
The window itself is a host annotation; device work is clipped to it.

`Trace` holds the device activities (kernels, copies, sets) and the host
operations inside the window, and reduces them: busy time (the union of
device intervals), time in the kernels a name pattern matches, the device
operations that took most time, and the longest idle gaps named by the host
operation that was running at each one's midpoint.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "perfbench.window"


def _is_annotation(e) -> bool:
    if e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


class Trace:
    def __init__(self, events):
        from torch.autograd import DeviceType

        win = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} window annotations, not 1")
        self.t0, self.t1 = win[0].start_ns(), win[0].end_ns()
        dev, host = [], []
        for e in events:
            if _is_annotation(e) or e.name() == WINDOW:
                continue
            s, t = e.start_ns(), e.end_ns()
            if t <= self.t0 or s >= self.t1:
                continue
            item = (max(s, self.t0), min(t, self.t1), e.name())
            (dev if e.device_type() == DeviceType.CUDA else host).append(item)
        dev.sort()
        self.device = dev
        self.host = host
        self.window_s = (self.t1 - self.t0) / 1e9
        self.busy_s, self.gaps = self._union()

    def _union(self) -> Tuple[float, List[Tuple[int, int]]]:
        busy, gaps = 0, []
        end = self.t0
        cur_s = cur_e = None
        for s, t, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                gaps.append((end, s))
                cur_s, cur_e = s, t
            else:
                cur_e = max(cur_e, t)
            end = cur_e
        if cur_e is not None:
            busy += cur_e - cur_s
        gaps.append((end, self.t1))
        return busy / 1e9, [g for g in gaps if g[1] > g[0]]

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the activities whose names match `pattern`."""
        rx = re.compile(pattern)
        return sum(t - s for s, t, name in self.device if rx.search(name)) / 1e9

    def kernel_count(self) -> int:
        """Kernel launches (device activities that are not copies or sets)."""
        return sum(1 for _, _, n in self.device
                   if not n.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset")))

    def device_ops(self, k: int = 10) -> List[List]:
        per: Dict[str, int] = {}
        for s, t, name in self.device:
            per[name] = per.get(name, 0) + (t - s)
        top = sorted(per.items(), key=lambda x: -x[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10, longest: int = 400) -> List[List]:
        """Idle seconds by the innermost host operation running at each of the
        `longest` gaps' midpoints, the `k` largest sums."""
        if not self.gaps:
            return []
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:longest]
        starts = np.array([h[0] for h in self.host], dtype=np.int64)
        ends = np.array([h[1] for h in self.host], dtype=np.int64)
        span = ends - starts
        per: Dict[str, int] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            name = "no host operation"
            if len(starts):
                cover = (starts <= mid) & (ends >= mid)
                if cover.any():
                    i = int(np.argmin(np.where(cover, span, np.iinfo(np.int64).max)))
                    name = self.host[i][2]
            per[name] = per.get(name, 0) + (b - a)
        top = sorted(per.items(), key=lambda x: -x[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]


class Tracer:
    """`with tracer.window(): ...` marks the measured window; with `on` the
    whole run of it is profiled and `trace` is set when it closes."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None
        self.window_s: Optional[float] = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            t = time.perf_counter()
            yield
            self.window_s = time.perf_counter() - t
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        pad = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            for _ in range(256):
                pad.add_(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with record_function(WINDOW):
                yield
            self.window_s = time.perf_counter() - t
            for _ in range(64):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
        self.trace = Trace(prof.profiler.kineto_results.events())
