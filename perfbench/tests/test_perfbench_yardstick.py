"""The yardstick on the CPU: operation and byte counts against hand counts,
the order statistics, the open-loop schedule and its lateness, the files
each cell and metric is found by, and the contract's shape of
BENCHMARK.json."""

from __future__ import annotations

import re
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from perfbench import flops, spec
from perfbench.loops.serve_open import Requests, schedule
from perfbench.stats import percentile, rel_err

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_vit_forward_ops_by_hand():
    # 2 layers, D 4, F 8, patch 2, 3 channels, 4 patches + CLS
    cfg = {"hidden_size": 4, "num_hidden_layers": 2, "intermediate_size": 8,
           "patch_size": 2, "num_channels": 3}
    n = 5
    patch = 2 * 4 * (2 * 2 * 3) * 4
    per_layer = 2 * n * 4 * 12 + 2 * n * 4 * 4 + 2 * n * 4 * 8 + 2 * n * 8 * 4
    attention = 4 * n * n * 4
    assert flops.vit_forward_ops(cfg, n, 4) == patch + 2 * (per_layer + attention)


def test_attention_calls_by_hand():
    # B 2, N 3, H 2, dh 4
    assert flops.attention_ops(2, 2, 3, 3, 4) == 2 * 2 * (2 * 2 * 3 * 3 * 4)
    call = flops.packed_attention_call(2, 3, 2, 4, "int8", "int8")
    assert call["bytes"] == 2 * 3 * 24 + 2 * 3 * 8
    masked = flops.masked_attention_call(2, 3, 2, 4, "bf16", 1, "f32")
    assert masked["bytes"] == 4 * (2 * 2 * 3 * 4) * 2 + 2 * 9 * 4
    lse = flops.packed_attention_lse_call(2, 3, 2, 4)
    assert lse["bytes"] == 2 * (2 * 3 * 24 + 2 * 3 * 8) + 4 * 2 * 2 * 3
    bwd = flops.packed_attention_bwd_call(2, 3, 2, 4)
    assert bwd["ops"] == 2.5 * flops.attention_ops(2, 2, 3, 3, 4)
    assert bwd["bytes"] == 2 * (2 * 3 * 24 * 2 + 2 * 2 * 3 * 8) + 4 * 2 * 2 * 3


@pytest.mark.parametrize("ops,nbytes,dtype,want", [
    (989e12, 1.0, "bf16", 1.0),          # bound by operations
    (1.0, 3.35e12, "int8", 1.0),         # bound by bytes
    (1979e12, 3.35e12 * 2, "int8", 2.0),
])
def test_least_seconds_takes_the_larger_bound(ops, nbytes, dtype, want):
    assert flops.least_seconds(ops, nbytes, dtype) == pytest.approx(want)


@pytest.mark.parametrize("q", [0, 25, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).exponential(size=101)
    assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_p95_counts_failed_requests_as_slowest():
    # 100 requests, 10 of them never answered: they count as answered when
    # the run gave up (here 60 s past due), so the 95th percentile is theirs
    lat = np.concatenate([np.full(90, 0.1), np.full(10, 60.0)])
    assert percentile(lat, 95) == 60.0
    # four of a hundred never answered stay beyond the 95th percentile
    assert percentile([0.1] * 96 + [60.0] * 4, 95) == pytest.approx(0.1)


def test_rel_err_rows():
    want = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    got = torch.tensor([[3.0, 4.5], [1.0, 0.0]])
    assert rel_err(got, want).tolist() == pytest.approx([0.1, 0.0])


def test_schedule_is_fixed_by_the_seed():
    due, idx = schedule(760.0, 10, 256, 2**40 + 5)
    assert len(due) == 7600 and (np.diff(due) >= 0).all()
    assert due.min() >= 0 and due.max() < 10 and idx.max() < 256
    again, idx2 = schedule(760.0, 10, 256, 2**40 + 5)
    assert (again == due).all() and (idx2 == idx).all()
    other, _ = schedule(760.0, 10, 256, 2**40 + 6)
    assert len(other) == len(due) and not (other == due).all()


class _Echo:
    """A server that answers each request on a thread after `delay` s."""

    def __init__(self, delay: float):
        self.delay = delay

    def submit(self, x):
        fut = Future()
        threading.Timer(self.delay, fut.set_result, (torch.zeros(2) + float(x),)).start()
        return fut


def test_generator_keeps_to_due_times_and_times_from_them():
    due = np.linspace(0.0, 0.2, 21)
    reqs = Requests(due, np.arange(21), width=2)
    t0 = time.perf_counter()
    reqs.drive(_Echo(0.05), np.arange(21.0), t0)
    assert reqs.all_done.wait(5)
    late = reqs.sent - due
    assert (late >= 0).all() and percentile(late, 50) < 0.01
    lat = reqs.done - due
    assert (lat >= 0.05).all() and (lat < 0.5).all()
    assert (reqs.answers[:, 0] == np.arange(21.0)).all()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_is_found_by_its_name(metric):
    reader = spec.reader(metric)
    run = type("Run", (), {"trace": None, "counts": {}})()
    assert reader.read(run) is None  # nothing to read: no value, never 0


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = spec.cell(BENCH, cell)
    config = spec.config(BENCH, c["config"])
    assert config["name"] == c["config"] and config["reduced"] == []
    traffic = spec.traffic(c["traffic"])
    assert (spec.HERE / "loops" / f"{traffic['loop']}.py").exists()
    limits = spec.limits(cell)
    assert limits["control"] in ("int4", "int8", "fp8")
    assert all(limits[k]["limit"] >= 0 for k in limits if k != "control")
    e2e = [m["name"] for m in spec.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer(BENCH, cell)


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["perfbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (spec.ROOT / c["file"]).exists()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in spec.end_to_end(BENCH, cell)]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
