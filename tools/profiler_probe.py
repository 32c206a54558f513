"""How often `torch.profiler` loses kernel launches at a profile's start, on
one CUDA card, with and without `chip_smoke.py`'s lead-in.

    python3 tools/profiler_probe.py [SECONDS]   # from the repo root; default 90

Times K4 (`fused_attention_inference`, bf16 [8,12,816,64], f32 mask
[8,1,816,816]) in 10-call profiles, taking turns: "bare" (64 one-element
adds, a mark, the calls, a mark, 64 adds: the readout `chip_smoke.py` used
before its lead-in) and "lead-in" (`chip_smoke._profiled_calls`).  A profile
fails when a mark is lost or the count of K4 launches between the marks is
not 10.  For every profile it also matches each launch (the runtime's
`cudaLaunchKernel` event) with its kernel by correlation id: the launches
with no kernel are lost, and kernel start minus launch start is the skew of
the card's clock against the host's (negative: the card's timestamps read
early).  Prints one JSON line per protocol.
"""
import json
import os
import re
import statistics
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402

PATTERN = "flash_mma_kernel"
RUNS = 10


def _bare(fn, pad):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(64):
            pad.add_(1)
        torch.cuda._sleep(1)
        for _ in range(RUNS):
            fn()
        torch.cuda._sleep(1)
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
    return prof


def _lead_in(fn, pad):
    """chip_smoke._profiled_calls' first attempt, keeping the profile."""
    from torch import profiler

    kept = {}
    real = profiler.profile

    class Keep(real):
        def __exit__(self, *a):
            out = super().__exit__(*a)
            kept["prof"] = self
            return out

    profiler.profile = Keep
    try:
        chip_smoke._profiled_calls(fn, RUNS, 0)
    finally:
        profiler.profile = real
    return kept["prof"]


def _read(prof) -> dict:
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    ok = len(marks) == 2 and sum(
        1 for e in events[marks[0] + 1:marks[1]] if re.search(PATTERN, e.name)) == RUNS
    raw = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id(): e for e in raw if e.device_type() == DeviceType.CUDA}
    launches = [e for e in raw if e.device_type() != DeviceType.CUDA
                and e.name() == "cudaLaunchKernel"]
    skews = [(kernels[e.correlation_id()].start_ns() - e.start_ns()) / 1e3
             for e in launches if e.correlation_id() in kernels]
    return dict(ok=ok, launches=len(launches), lost=len(launches) - len(skews),
                skew_us_min=min(skews, default=0.0))


def main() -> None:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 90.0
    smi = chip_smoke.card()
    sys.path.insert(0, chip_smoke.ROOT)
    from msvit_tpu_torch.ops import _build
    from msvit_tpu_torch.ops.fused_attention import fused_attention_inference

    _build.library()
    b, h, n, dh = chip_smoke.MS_SHAPE
    g = torch.Generator().manual_seed(8)
    x = torch.randn(b, h, n, dh, generator=g).to("cuda", torch.bfloat16)
    mask = torch.where(torch.rand(b, 1, n, n, generator=g) < 0.5, 0.0, -100.0).cuda()

    def fn():
        return fused_attention_inference(x, x, x, mask=mask)

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    seen = {"bare": [], "lead-in": []}
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for name, take in (("bare", _bare), ("lead-in", _lead_in)):
            seen[name].append(_read(take(fn, pad)))
    for name, rows in seen.items():
        skews = [r["skew_us_min"] for r in rows]
        print(json.dumps({
            "protocol": name, "profiles": len(rows),
            "failed": sum(not r["ok"] for r in rows),
            "with_lost_launches": sum(r["lost"] > 0 for r in rows),
            "lost_launches_max": max(r["lost"] for r in rows),
            "launches_per_profile": statistics.median(r["launches"] for r in rows),
            "skew_us_min": min(skews), "skew_us_median_of_min": statistics.median(skews),
            "card": smi}), flush=True)


if __name__ == "__main__":
    main()
