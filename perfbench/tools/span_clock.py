"""Do the program's spans lie on the device trace's clock, and where does
a cell's window go by them?  One traced run of a cell, then, against the
window's device activities:

- each `serve.launch` span's start L against the first device activity
  that begins at or after L - 50 us: where the device was idle at L, that
  activity is the batch's first (nothing else was queued), so it cannot
  begin before L on one clock;
- each `serve.device_wait` span's end W (the host saw the batch's event)
  against the last device activity that ended at or before W + 50 us: the
  batch's last, which cannot end after W;
- in the forwards that lie wholly in the window (`msvit.forward`), the
  runtime's synchronising calls in the trace against the program's
  `sync.*` spans, each call put down to the `sync.*` span open at it (the
  same count on both sides, and no call outside a span, means the spans
  name every sync);
- for every span name, the spans that began in the window: their count,
  host seconds, the device's idle seconds under them, and device seconds
  where they carry CUDA events.

    python3 -m perfbench.tools.span_clock --workload vit-b16.int8-serve --seed 5

Prints the run's result line, then one JSON line: the quartiles and least
value of each lead in microseconds (negative: the device seemed to act
before the host; none in a cell without a server), the syncs (none in a
cell without a multistate forward) and the account.
"""

from __future__ import annotations

import argparse
import bisect
import json

from perfbench import run as bench_run
from perfbench import spans
from perfbench.stats import percentile

SLACK_NS = 50_000


def leads(run):
    device = run.trace.device
    starts = [s for s, _, _ in device]
    ends = sorted(t for _, t, _ in device)
    gaps = run.trace.gaps
    found = spans.in_window(run, "serve.") or []
    launch, wait = [], []
    for s in spans.named(found, "serve.launch"):
        at = s["start_ns"]
        idle = any(a <= at < b for a, b in gaps)
        i = bisect.bisect_left(starts, at - SLACK_NS)
        if idle and i < len(starts):
            launch.append((starts[i] - at) / 1e3)
    for s in spans.named(found, "serve.device_wait"):
        at = s["end_ns"]
        i = bisect.bisect_right(ends, at + SLACK_NS)
        if i:
            wait.append((at - ends[i - 1]) / 1e3)
    return launch, wait


def syncs(run):
    """Per whole forward in the window: the runtime's synchronising calls,
    the `sync.*` spans, and the calls by the `sync.*` span open at each
    ("none" where no span was)."""
    found = spans.in_window(run) or []
    forwards = spans.whole(run, spans.named(found, "msvit.forward"))
    if not forwards:
        return None
    intervals = [(s["start_ns"], s["end_ns"]) for s in forwards]
    inside = [s for s in found if s["name"].startswith("sync.")
              and any(a <= s["start_ns"] and s["end_ns"] <= b for a, b in intervals)]
    by_site = {}
    for at, _ in spans.host_syncs_under(run, intervals):
        open_at = [s for s in inside if s["start_ns"] <= at < s["end_ns"]]
        site = max(open_at, key=lambda s: s["start_ns"])["name"] if open_at else "none"
        by_site[site] = by_site.get(site, 0) + 1
    n = len(forwards)
    return {"forwards": n, "runtime_per_forward": sum(by_site.values()) / n,
            "spans_per_forward": len(inside) / n,
            "runtime_by_span": {k: v / n for k, v in sorted(by_site.items())}}


def account(run):
    """Per span name: count, host_s, idle_s, and device_s where timed."""
    found = spans.started(run, spans.in_window(run) or [])
    out = {}
    for name in sorted({s["name"] for s in found}):
        mine = spans.named(found, name)
        row = {"count": len(mine),
               "host_s": sum(s["t1"] - s["t0"] for s in mine) / 1e9,
               "idle_s": spans.idle_seconds_under(run, [(s["t0"], s["t1"]) for s in mine])}
        timed = [s["device_ms"] for s in mine if "device_ms" in s]
        if timed:
            row["device_s"] = sum(timed) / 1e3
        out[name] = row
    return out


def summary(xs):
    if not xs:
        return None
    return {"n": len(xs), "min_us": min(xs), "q1_us": percentile(xs, 25),
            "median_us": percentile(xs, 50), "q3_us": percentile(xs, 75)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vit-b16.int8-serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    kept = {}
    init = bench_run.Run.__init__

    def keep(self, ctx, out):
        init(self, ctx, out)
        kept["run"] = self

    bench_run.Run.__init__ = keep
    rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])
    run = kept["run"]
    launch, wait = leads(run)
    print(json.dumps({"launch_to_first_activity": summary(launch),
                      "last_activity_to_wait_end": summary(wait),
                      "syncs": syncs(run),
                      "window_s": run.trace.window_s, "busy_s": run.trace.busy_s,
                      "account": account(run)}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
