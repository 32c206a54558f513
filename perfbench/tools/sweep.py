"""Find the knee of an open-loop serving cell by a sweep of offered rates.

    python3 -m perfbench.tools.sweep --workload vit-b16.int8-serve --seed 7 \\
        --seconds 10 --rates 600 700 800 900 1000 1100

One process builds the cell's program once and offers each rate for
`--seconds` in turn (the cell's traffic file with only its rate replaced).
For each rate it prints one JSON line: the share of offered requests
answered inside the window, the backlog (requests sent and not answered)
at the window's middle and at its end, the median and 95th percentile of
the latency from due time, and the mean batch.  The knee is the highest
rate at which at least 99% are answered in the window and the backlog
does not grow from the middle to the end; the cell's rate is set below it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from perfbench import spec
from perfbench.loops.serve_open import Served, schedule
from perfbench.stats import percentile


def backlog(sent: np.ndarray, done: np.ndarray, t: float) -> int:
    return int((sent <= t).sum() - (np.nan_to_num(done, nan=np.inf) <= t).sum())


def mean_batch(before: dict, after: dict) -> float:
    """Requests per batch between two `BatchingServer.stats()` readings."""
    batches = after["batches"] - before["batches"]
    return (after["requests"] - before["requests"]) / batches if batches else float("nan")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, tr = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    served = Served(cfg, tr, args.seed, torch.device("cuda", 0))
    torch.cuda.synchronize()
    for rate in args.rates:
        before = served.server.stats()
        due, idx = schedule(rate, args.seconds, len(served.pool), args.seed)
        reqs, done, gave_up = served.offer(due, idx, args.seconds, tr["drain_s"])
        lat = np.where(np.isnan(done), gave_up, done) - due
        print(json.dumps({
            "rate": rate, "offered": len(due),
            "answered_in_window": float((done <= args.seconds).mean()),
            "backlog_mid": backlog(reqs.sent, done, args.seconds / 2),
            "backlog_end": backlog(reqs.sent, done, args.seconds),
            "p50_ms": percentile(lat, 50) * 1e3, "p95_ms": percentile(lat, 95) * 1e3,
            "mean_batch": mean_batch(before, served.server.stats()),
            "lateness_p99_ms": percentile(reqs.sent - due, 99) * 1e3}), flush=True)
    served.server.close()


if __name__ == "__main__":
    main()
