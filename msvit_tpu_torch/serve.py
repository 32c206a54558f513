"""Dynamic micro-batching inference server (counterpart of
`msvit_tpu/serve.py`).

Requests arrive one image at a time and the card wants batches:

* **Static bucket shapes.**  Requests are padded up to the next bucket
  (powers of two up to `max_batch`) and the padding rows are sliced off
  the result, so every launch has one of a few shapes; `warmup()` runs
  each bucket once before traffic.
* **Deadline-based coalescing.**  The dispatcher drains whatever is
  queued; if the batch is still below `max_batch` it waits at most
  `max_wait_ms` for stragglers, then launches.  CUDA launches are
  asynchronous, so the host coalesces batch i+1 while the card runs
  batch i; a completer thread copies results to the host, with at most
  two batches in flight.
* **Thread-safe `submit` -> Future.**  Callers block only on their own
  result.
* **Small-bucket routing.**  Buckets of at most `small_bucket_max` go to
  `small_apply_fn` (an int8 deployment sends its tiny batches to a bf16
  program).

Device notes.  Grad and inference mode are thread-local in PyTorch, so an
apply function enters `torch.inference_mode()` itself: it runs in the
dispatcher thread.  After each launch the dispatcher records a CUDA event
on its current stream, and the completer waits on that event before the
synchronous `.cpu()` copy, so the two threads agree whatever stream the
apply function used.

Latency is measured per request on a monotonic clock (queued -> result
on the host) and reported as p50/p95/p99 by `stats()`.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs), q))


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _to_host(tree: Any) -> Any:
    """Tensors -> CPU tensors (a synchronous copy: returns once the data
    has landed); anything else passes through."""
    return _tree_map(
        lambda o: o.detach().cpu() if isinstance(o, torch.Tensor) else o, tree
    )


def _cuda_event(tree: Any) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream of the device of the first
    CUDA tensor in `tree` (None when there is none)."""
    for o in _leaves(tree):
        if isinstance(o, torch.Tensor) and o.is_cuda:
            with torch.cuda.device(o.device):
                ev = torch.cuda.Event()
                ev.record()
            return ev
    return None


class BatchingServer:
    """`apply_fn(batch)` takes one numpy [B, ...] array and returns a tensor
    (or array, or a dict/tuple of them) with B rows; results are handed
    back row by row, on the host."""

    def __init__(
        self,
        apply_fn: Callable[[np.ndarray], Any],
        example: np.ndarray,  # one example, no batch dim
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        small_apply_fn: Optional[Callable[[np.ndarray], Any]] = None,
        small_bucket_max: int = 0,
    ):
        self.apply_fn = apply_fn
        self.small_apply_fn = small_apply_fn
        self.small_bucket_max = int(small_bucket_max)
        self.example_shape = tuple(example.shape)
        self.example_dtype = example.dtype
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        # bounded in-flight launches: the dispatcher coalesces batch i+1
        # while the completer waits on batch i (depth 2 = double buffer)
        self._cq: "queue.Queue" = queue.Queue(maxsize=2)
        self._latencies: List[float] = []
        self._batch_sizes: List[int] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._thread.start()
        self._completer.start()

    # ---- client API ----

    def submit(self, x: np.ndarray) -> Future:
        if tuple(x.shape) != self.example_shape:
            raise ValueError(
                f"request shape {tuple(x.shape)} != {self.example_shape}"
            )
        fut: Future = Future()
        self._q.put((time.monotonic(), np.asarray(x, self.example_dtype), fut))
        return fut

    def warmup(self) -> None:
        """Run every bucket once before serving traffic; the copy of each
        output to the host is the fence."""
        for b in self.buckets:
            x = np.zeros((b,) + self.example_shape, self.example_dtype)
            _to_host(self._fn_for_bucket(b)(x))

    def stats(self) -> dict:
        with self._lock:
            lats = list(self._latencies)
            sizes = list(self._batch_sizes)
        return {
            "requests": len(lats),
            "p50_ms": _percentile(lats, 50) * 1e3,
            "p95_ms": _percentile(lats, 95) * 1e3,
            "p99_ms": _percentile(lats, 99) * 1e3,
            "mean_batch": float(np.mean(sizes)) if sizes else float("nan"),
            "batches": len(sizes),
        }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        try:
            self._cq.put_nowait(None)
        except queue.Full:
            pass
        self._completer.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatcher ----

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _fn_for_bucket(self, b: int) -> Callable[[np.ndarray], Any]:
        if self.small_apply_fn is not None and b <= self.small_bucket_max:
            return self.small_apply_fn
        return self.apply_fn

    def _collect(self) -> list:
        """Block for the first request, then coalesce up to max_batch for
        at most max_wait."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                items.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return items

    def _dispatch(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            b = self._bucket(len(items))
            batch = np.zeros((b,) + self.example_shape, self.example_dtype)
            for i, (_, x, _) in enumerate(items):
                batch[i] = x
            try:
                out = self._fn_for_bucket(b)(batch)  # asynchronous launch
                ev = _cuda_event(out)
            except Exception as e:  # shape or launch error: fail these fast
                for _, _, fut in items:
                    fut.set_exception(e)
                continue
            # bounded queue: at most 2 batches in flight on the device
            self._cq.put((out, ev, items))

    def _complete(self) -> None:
        while True:
            task = self._cq.get()
            if task is None:
                return
            out, ev, items = task
            try:
                if ev is not None:
                    ev.synchronize()
                out = _to_host(out)
            except Exception as e:  # device-side failure
                for _, _, fut in items:
                    fut.set_exception(e)
                continue
            done = time.monotonic()
            with self._lock:
                self._batch_sizes.append(len(items))
                for t0, _, _ in items:
                    self._latencies.append(done - t0)
            for i, (_, _, fut) in enumerate(items):
                fut.set_result(_tree_map(lambda o: o[i], out))
