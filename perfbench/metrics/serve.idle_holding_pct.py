"""Share of the traced window in which the device was idle while the
server's dispatcher held requests and had not begun their launch: each
`serve.batch` span up to the start of its `serve.launch` (coalescing the
stragglers and assembling the batch)."""

from perfbench import spans


def read(run):
    found = spans.in_window(run, "serve.")
    if found is None or not run.trace.window_s:
        return None
    held = spans.before_child(found, "serve.batch", "serve.launch")
    return 100.0 * spans.idle_seconds_under(run, held) / run.trace.window_s
