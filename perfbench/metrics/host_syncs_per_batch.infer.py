"""Host syncs a forward: the CUDA runtime's synchronising calls in the
device trace (`spans.SYNC_CALLS`) that began inside the `msvit.forward`
spans lying wholly in the traced window, over those forwards.  The
program's `sync.*` spans only name where each comes from
(`perfbench.tools.span_clock`)."""

from perfbench import spans


def read(run):
    forwards = spans.in_window(run, "msvit.forward")
    if forwards is None:
        return None
    forwards = spans.whole(run, spans.named(forwards, "msvit.forward"))
    if not forwards:
        return None
    calls = spans.host_syncs_under(run, [(s["start_ns"], s["end_ns"]) for s in forwards])
    return len(calls) / len(forwards)
