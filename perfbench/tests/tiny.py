"""Tiny configurations and traffic for the benchmark's CPU tests, and a
loop's run at that size."""

from __future__ import annotations

import json

import torch

from perfbench import spec
from perfbench.run import Context

VIT = dict(spec._json(spec.HERE / "configs" / "vit-b16.json"), hidden_size=64,
           num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
           image_size=32, num_labels=10)
_MS = spec._json(spec.HERE / "configs" / "msvit-b8.json")
MULTISTATE = dict(_MS, hidden_size=64, num_hidden_layers=7, num_attention_heads=4,
                  intermediate_size=128, image_size=32,
                  clustering=dict(_MS["clustering"], max_clusters=4, ncut_dim=2,
                                  num_sample=32, late_num_sample=16))

TRAFFIC = {
    "int8-serve": dict(rate=40.0, pool_images=8, calibration_images=4, max_batch=8,
                       drain_s=10.0),
    "int8-bs32": dict(batch=4, pool_batches=2),
    "bf16-bs32": dict(batch=4, pool_batches=2),
    "train-bs256": dict(batch=8),
}


def cell(name: str):
    """(cell, tiny config, tiny traffic) of a cell of BENCHMARK.json."""
    c = spec.cell(spec.benchmark(), name)
    config = VIT if c["config"] == "vit-b16" else MULTISTATE
    traffic = dict(spec.traffic(c["traffic"]), **TRAFFIC[c["traffic"]])
    return c, config, traffic


def run(name: str, seed: int = 2**31 + 11, seconds: float = 1.0):
    """A loop's run of the cell at the tiny size on the CPU: (output,
    whether every compared number is within the cell's limit)."""
    import importlib

    c, config, traffic = cell(name)
    ctx = Context(c, config, traffic, seed, seconds, False, torch.device("cpu"))
    out = importlib.import_module(f"perfbench.loops.{traffic['loop']}").run(ctx)
    limits = spec.limits(name)
    ok = all(v <= limits[k]["limit"] for k, v in out["check"].items())
    return out, ok


def dumps(x) -> str:
    return json.dumps(x, default=float)
