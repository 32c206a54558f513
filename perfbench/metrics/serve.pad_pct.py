"""Padding rows over the rows launched in the traced window (the buckets of
the `serve.batch` spans against their requests): work the device did for
no request."""

from perfbench import spans


def read(run):
    batches = spans.in_window(run, "serve.batch")
    if batches is None:
        return None
    batches = spans.started(run, batches)
    rows = sum(b["attrs"]["bucket"] for b in batches)
    pad = sum(b["attrs"]["bucket"] - b["attrs"]["requests"] for b in batches)
    return 100.0 * pad / rows if rows else None
