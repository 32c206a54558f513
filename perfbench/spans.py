"""The program's own spans in a traced window, for the readers that take
their numbers from inside the program.

The port records spans (`msvit_tpu_torch.utils.profiling`) while a
profiler is active, from every thread, on the clock of the profiler's
events (`time.time_ns()`), so they line up with the window's device
intervals and idle gaps (`Trace.gaps`).  A program without that recorder,
or a window in which it recorded nothing, gives None: the readers then
report nothing.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple


def in_window(run, prefix: str = "") -> Optional[List[Dict]]:
    """The program's spans whose names start with `prefix` and that overlap
    the traced window, oldest first, each with `t0` and `t1`: its interval
    clipped to the window (its own `start_ns` and `end_ns` unchanged).  None
    where there is no trace, the program keeps no spans, or it recorded
    none in the window."""
    if run.trace is None:
        return None
    try:
        from msvit_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    lo, hi = run.trace.t0, run.trace.t1
    out = [dict(s, t0=max(s["start_ns"], lo), t1=min(s["end_ns"], hi)) for s in read(lo)
           if s["start_ns"] < hi and s["name"].startswith(prefix)]
    return out or None


def started(run, spans: Iterable[Dict]) -> List[Dict]:
    """The spans that began inside the window (a count of work done in it)."""
    return [s for s in spans if s["start_ns"] >= run.trace.t0]


def named(spans: Iterable[Dict], name: str) -> List[Dict]:
    return [s for s in spans if s["name"] == name]


def before_child(spans: List[Dict], parent: str, child: str) -> List[Tuple[int, int]]:
    """Each `parent` span's clipped interval up to the start of its first
    `child` span (the whole interval where it has none)."""
    first: Dict[int, int] = {}
    for s in named(spans, child):
        first[s["parent"]] = min(first.get(s["parent"], s["t0"]), s["t0"])
    return [(p["t0"], min(p["t1"], first.get(p["id"], p["t1"]))) for p in named(spans, parent)]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[int]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_seconds_under(run, intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds in which the device was idle (`run.trace.gaps`) and some
    interval was open."""
    covered = union(intervals)
    gaps = run.trace.gaps
    total, i = 0, 0
    for a, b in covered:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total / 1e9


# the CUDA runtime calls at which the host waits for the device (a
# blocking copy is an asynchronous one plus cudaStreamSynchronize)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize",
                        "cudaDeviceSynchronize", "cudaMemcpy"})


def whole(run, spans: Iterable[Dict]) -> List[Dict]:
    """The spans that lie wholly inside the window."""
    return [s for s in spans if s["start_ns"] >= run.trace.t0 and s["end_ns"] <= run.trace.t1]


def host_syncs_under(run, intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, str]]:
    """The runtime's synchronising calls in the trace (`run.trace.host`)
    that began inside some interval: (start, name), oldest first."""
    covered = union(intervals)
    starts = [a for a, _ in covered]
    out = []
    for s, _, name in run.trace.host:
        if name in SYNC_CALLS:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < covered[i][1]:
                out.append((s, name))
    return sorted(out)


def device_ms_per(run, phase: str, per: str) -> Optional[float]:
    """Device milliseconds of the `phase` spans (their CUDA events) that began
    in the window, over the number of `per` spans that began in it."""
    spans = in_window(run, "train.")
    if spans is None:
        return None
    spans = started(run, spans)
    count = len(named(spans, per))
    timed = [s["device_ms"] for s in named(spans, phase) if "device_ms" in s]
    return sum(timed) / count if count and timed else None
