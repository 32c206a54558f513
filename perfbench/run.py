"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A new process per run.  It builds the cell's program on the card from the
seed, warms up the cell's own shapes, drives the cell's traffic for
`--seconds` (the loop that `traffic/<mix>.json` names), compares what the
window produced with the plain reference, and prints one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `check`: each number compared
beside its limit, which also close standard error.  Without a CUDA card,
or with fewer cards than the cell asks for, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from perfbench import spec  # noqa: E402
from perfbench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "msvit_tpu")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Context:
    """What a loop gets: the cell's files, the seed, the window's length,
    the device, and the hooks that time set-up, mark the window and read the
    memory peak."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict, seed: int,
                 seconds: float, trace: bool, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.tracer = Tracer(trace)
        self.setup_s: Optional[float] = None
        self.memory_peak: Optional[int] = None
        self._setup_peak = 0
        self.log = log

    def window(self):
        """The measured window; set-up ends where it begins.  Every object
        that set-up made is moved out of the collector's reach first
        (`gc.freeze`, as a long-running server does after its warm-up):
        otherwise one full collection over them, some 170,000 objects,
        stops every thread of the process for ~140 ms at a moment the run
        does not choose.  The device's memory peak starts anew here, so
        that the window's own peak can be read apart (`memory_so_far`)."""
        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            import torch

            self._setup_peak = int(torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.perf_counter() - T_START
        return self.tracer.window()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_so_far(self) -> Optional[int]:
        """The peak of allocated device memory since the window began, as
        the host has allocated it (no wait for the device)."""
        import torch

        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    def read_memory_peak(self) -> None:
        """`memory_peak`: the process's peak of allocated device memory,
        set-up and window."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = max(self._setup_peak, self.memory_so_far())


class Run:
    """What a per-layer reader gets: the cell's files, the trace of the
    window and the loop's counts."""

    def __init__(self, ctx: Context, out: Dict):
        self.cell, self.config, self.traffic = ctx.cell, ctx.config, ctx.traffic
        self.trace = ctx.tracer.trace
        self.counts = out["counts"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no CUDA card for {cell['name']} (available: {torch.cuda.is_available()}, "
            f"cards: {torch.cuda.device_count()}, the cell asks for {cell['chips']}); "
            "there is no CPU fallback")
        return 2
    dev = torch.device("cuda", 0)
    card = power_limit()
    ctx = Context(cell, config, traffic, args.seed, args.seconds, bool(args.trace), dev)
    loop = importlib.import_module(f"perfbench.loops.{traffic['loop']}")
    out = loop.run(ctx)

    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3

    if args.trace:
        run = Run(ctx, out)
        metrics = {}
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end(bench, cell["name"])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    trace = ctx.tracer.trace
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}

    check, correct = {}, True
    for name, value in out["check"].items():
        limit = limits[name]["limit"]
        check[name] = {"value": value, "limit": limit}
        correct = correct and not math.isnan(value) and value <= limit
    result["correct"] = correct
    result["check"] = check
    log(f"{cell['name']} seed {args.seed} on {card}: setup {ctx.setup_s!r} s, "
        f"window {ctx.tracer.window_s!r} s")
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
