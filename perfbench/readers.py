"""What several per-layer readers share; each reader in `metrics/` names
its own kernels and counts and calls one of these."""

from __future__ import annotations

from typing import Optional

from perfbench.flops import calls_least_seconds


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    t = run.trace
    return None if t is None or not t.window_s else 100.0 * (t.window_s - t.busy_s) / t.window_s


def roofline(run, kernels: str, calls: str) -> Optional[float]:
    """The least time of the attention calls `run.counts[calls]` (from the
    shapes the model hands the kernel) over the device time of the kernels
    whose names match `kernels`, in %; nothing where either is missing."""
    listed = run.counts.get(calls)
    if run.trace is None or not listed:
        return None
    seconds = run.trace.kernel_seconds(kernels)
    return 100.0 * calls_least_seconds(listed) / seconds if seconds else None
