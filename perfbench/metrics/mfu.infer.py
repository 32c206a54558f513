"""Trunk operations of the window's images (at every token, cluster slots
included; clustering left out) over the traced window's seconds times the
peak of the precision the trunk's products run in."""

from perfbench.flops import PEAK_OPS_PER_S


def read(run):
    if run.trace is None or "forward_ops" not in run.counts:
        return None
    ops = run.counts["images"] * run.counts["forward_ops"]
    return 100.0 * ops / (run.trace.window_s * PEAK_OPS_PER_S[run.counts["precision"]])
