"""Share of the traced window in which the device was idle while the host
was inside a clustering event (`msvit.recluster` spans)."""

from perfbench import spans


def read(run):
    events = spans.in_window(run, "msvit.recluster")
    if events is None or not run.trace.window_s:
        return None
    held = [(s["t0"], s["t1"]) for s in events]
    return 100.0 * spans.idle_seconds_under(run, held) / run.trace.window_s
