"""Mean images per dispatched batch, from `BatchingServer.stats()`."""


def read(run):
    return run.counts.get("mean_batch")
