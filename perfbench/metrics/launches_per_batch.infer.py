"""Kernel launches on the device per forward in the traced window."""


def read(run):
    if run.trace is None or not run.counts.get("batches"):
        return None
    return run.trace.kernel_count() / run.counts["batches"]
