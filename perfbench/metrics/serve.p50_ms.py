"""Median latency of the window's requests, each from its due time to its
response on the host (a missing answer counts as the run's give-up time)."""

from perfbench.stats import percentile


def read(run):
    lat = run.counts.get("latency_s")
    return None if lat is None or not len(lat) else percentile(lat, 50) * 1e3
