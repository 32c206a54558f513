"""Model operations of the window's training steps (3 x the forward's, the
classifier head included; recomputation not counted) over the traced
window's seconds times the bf16 peak."""

from perfbench.flops import PEAK_OPS_PER_S


def read(run):
    if run.trace is None or not run.counts.get("steps"):
        return None
    ops = 3 * run.counts["images"] * run.counts["forward_ops"]
    return 100.0 * ops / (run.trace.window_s * PEAK_OPS_PER_S["bf16"])
