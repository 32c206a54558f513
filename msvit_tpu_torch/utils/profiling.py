"""Tracing: named spans on the device trace's clock, and a `torch.profiler`
wrapper (counterpart of `msvit_tpu/utils/profiling.py`, `torch.profiler`
where the JAX package has `jax.profiler`).

`span(name, device=False, **attrs)` marks a block of the program:

    with profiling.span("serve.launch"):
        out = apply_fn(batch)

Off, that is while no `torch.profiler` is active and no `record()` block is
open, it returns one shared no-op context: a check of a Python flag, no
allocation, no `record_function`.  On, it enters
`torch.profiler.record_function(name)`, so the span shows in an exported
trace wherever the profiler sees the thread, and it keeps the span in
memory: name, start and end in `time.time_ns()` (the clock of the
profiler's events: a span lines up with the device activities of a trace
taken beside it), thread, parent span (a stack per thread) and attrs.
The profiler records host operations only from threads that began after
it started; the recorder keeps the spans of every thread, a server's
long-lived threads included.

`device=True` (or a CUDA device) also records a CUDA event on the current
stream at the span's start and one at its end; they are resolved when the
spans are read, never inside the span, so a span adds no host-device sync.
`spans()` reads the buffer, a ring of the newest `LIMIT` spans (those
pushed out are counted in `dropped()`), `reset()` clears it, `summary()`
gives each name's count, host milliseconds and device milliseconds.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

LIMIT = 1 << 18  # spans kept, the newest; a bench window makes some thousands

_spans: Deque["Span"] = collections.deque()
_dropped = 0  # spans pushed out of the full buffer, the oldest first
_recording = 0  # `record()` blocks open
_lock = threading.Lock()
_local = threading.local()  # `stack`: each thread's open spans
_ids = itertools.count()


class _Off:
    """The shared context of a span while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        """Attributes known only inside the block (dropped: nothing records)."""


_OFF = _Off()


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(s: "Span") -> None:
    global _dropped
    with _lock:
        if len(_spans) >= LIMIT:
            _spans.popleft()
            _dropped += 1
        _spans.append(s)


class Span:
    """One recorded span.  `set(**attrs)` adds attributes from inside the
    block."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "thread", "id", "parent",
                 "_device", "_events", "_rf", "_device_ms")

    def __init__(self, name: str, device: Optional[torch.device], attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._device = device
        self._events = None
        self._device_ms: Optional[float] = None
        self.start_ns = self.end_ns = 0
        self.parent: Optional[int] = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        if self._device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            self._events = (start,)
        self.start_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        self._rf = None
        self.end_ns = time.time_ns()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._events = (self._events[0], end)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's two CUDA events (waits for
        the end event); None for a host span."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
               "thread": self.thread, "id": self.id, "parent": self.parent,
               "attrs": dict(self.attrs)}
        ms = self.device_ms()
        if ms is not None:
            out["device_ms"] = ms
        return out


def _cuda_device(device) -> Optional[torch.device]:
    """The CUDA device a span's events go to: `True` means the current one
    (none where the process has no card), a device its own if it is a CUDA
    device, `False` or None none."""
    if device is True:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    if device is None or device is False:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def span(name: str, device=False, **attrs: Any):
    """A span of the program (module docstring); `device` is True, a
    device, or False."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, _cuda_device(device), attrs)


@contextlib.contextmanager
def record() -> Iterator[None]:
    """Record spans without a profiler: ``with profiling.record(): ...``."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(since_ns: int = 0) -> List[Dict[str, Any]]:
    """The kept spans that ended at or after `since_ns` (all by default),
    oldest first, as dicts: name, start_ns, end_ns, thread, id, parent,
    attrs, and device_ms for a device span (its events are waited for)."""
    with _lock:
        kept = [s for s in _spans if s.end_ns >= since_ns]
    return [s.as_dict() for s in kept]


def dropped() -> int:
    """Spans pushed out of the full buffer (the oldest go first)."""
    return _dropped


def reset() -> None:
    """Forget every recorded span."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: `count`, `host_ms` (total), and `device_ms` (total)
    where the spans recorded CUDA events."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans():
        row = out.setdefault(s["name"], {"count": 0, "host_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (s["end_ns"] - s["start_ns"]) / 1e6
        if "device_ms" in s:
            row["device_ms"] = row.get("device_ms", 0.0) + s["device_ms"]
    return dict(sorted(out.items()))


def _chrome_trace(items: List[Dict[str, Any]], base_ns: int = 0) -> Dict[str, Any]:
    """Spans as Chrome-trace JSON: complete events in microseconds from
    `base_ns` (a kineto trace's `baseTimeNanoseconds`: the two files then
    share one time axis)."""
    pid = os.getpid()
    events = [{"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
               "tid": s["thread"], "ts": (s["start_ns"] - base_ns) / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "args": {k: v for k, v in s.items() if k not in ("name", "thread", "start_ns",
                                                                  "end_ns")}}
              for s in items]
    return {"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns, "traceEvents": events,
            "droppedSpans": dropped()}


def _kineto_base_ns(log_dir: str) -> int:
    """`baseTimeNanoseconds` of the newest trace the profiler wrote to
    `log_dir` (0 where there is none)."""
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if not files:
        return 0
    with open(max(files, key=os.path.getmtime)) as f:
        return int(json.load(f).get("baseTimeNanoseconds", 0))


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host and card trace into `log_dir` (a TensorBoard
    trace-handler directory; the card's activities when there is one), and
    the spans of the profiled interval, every thread's, into
    `log_dir/program_spans.json` (Chrome-trace JSON on the kineto trace's
    time axis):

        with profiling.trace("/tmp/trace") as prof:
            step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    t1 = time.time_ns()
    items = [s for s in spans(t0) if s["start_ns"] <= t1]
    with open(os.path.join(log_dir, "program_spans.json"), "w") as f:
        json.dump(_chrome_trace(items, _kineto_base_ns(log_dir)), f, default=str)
