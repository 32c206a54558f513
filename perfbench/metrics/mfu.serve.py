"""Model operations of the real images served in the traced window (padding
rows are waste) over the device's busy seconds in it times the int8 peak."""

from perfbench.flops import PEAK_OPS_PER_S


def read(run):
    if run.trace is None or not run.trace.busy_s or "forward_ops" not in run.counts:
        return None
    ops = run.counts["images"] * run.counts["forward_ops"]
    return 100.0 * ops / (run.trace.busy_s * PEAK_OPS_PER_S["int8"])
