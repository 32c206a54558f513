"""95th percentile of the queue wait of the requests launched in the traced
window, each from its `submit` to the start of its batch's launch: the
server's `serve.batch` spans (attr `waits_s`, seconds)."""

from perfbench import spans
from perfbench.stats import percentile


def read(run):
    batches = spans.in_window(run, "serve.batch")
    if batches is None:
        return None
    waits = [w * 1e3 for b in spans.started(run, batches)
             for w in b["attrs"].get("waits_s", ())]
    return percentile(waits, 95) if waits else None
