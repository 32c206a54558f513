"""The peak of allocated device memory over the window's steps before its
checked step (`torch.cuda.max_memory_allocated` after a reset where the
window begins, read before the check copies the state), in GiB."""


def read(run):
    peak = run.counts.get("window_peak_bytes")
    return None if not peak else peak / 2**30
