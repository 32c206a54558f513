"""`msvit_tpu_torch/utils/profiling.py`: spans off and on, their clock
against the profiler's events, the Chrome-trace file, the summary; and the
spans the program opens (the server's, each clustering event's, the
trainer step's), on the CPU at tiny sizes."""

import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msvit_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _named(name):
    return [s for s in profiling.spans() if s["name"] == name]


def test_off_is_one_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b", device=True, k=1)
    for _ in range(10):
        with profiling.span("a") as s:
            s.set(k=2)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with profiling.span("a"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, profiling.__file__)
    grown = sum(d.size_diff for d in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "filename"))
    assert grown == 0
    assert profiling.spans() == [] and profiling.summary() == {}


def test_spans_nest_with_attrs_from_a_thread_older_than_the_profiler():
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(10)
        with profiling.span("worker.outer", role="server") as s:
            with profiling.span("worker.inner"):
                torch.ones(4).sum()
            s.set(rows=3)
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("main.outer"):
            go.set()
            assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    outer, = _named("worker.outer")
    inner, = _named("worker.inner")
    main, = _named("main.outer")
    assert outer["attrs"] == {"role": "server", "rows": 3}
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["thread"] == inner["thread"] == t.ident != main["thread"]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert main["start_ns"] <= outer["start_ns"] and outer["end_ns"] <= main["end_ns"]
    assert "device_ms" not in outer  # no card: a host span
    with profiling.span("after"):  # the profiler closed: off again
        pass
    assert not _named("after")


def test_a_span_starts_where_the_profilers_event_does():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span(f"clock.{i}"):
                torch.ones(64).sum()
            time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    lead = sorted(events[s["name"]].start_ns() - s["start_ns"] for s in profiling.spans())
    # one clock: each span opens its record_function just after reading it
    # (~13 us here; the first ~160); a preempted span may lag, not the median
    assert len(lead) == 5 and abs(lead[2]) < 1_000_000, lead
    assert all(abs(x) < 50_000_000 for x in lead), lead


def test_trace_writes_the_program_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced", k=1):
            torch.ones(8).sum()
    with open(tmp_path / "program_spans.json") as f:
        doc = json.load(f)
    (ev,) = [e for e in doc["traceEvents"] if e["name"] == "traced"]
    assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["args"]["attrs"] == {"k": 1}
    kineto = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    with open(tmp_path / kineto[0]) as f:
        base = json.load(f)["baseTimeNanoseconds"]
    assert doc["baseTimeNanoseconds"] == base
    (s,) = _named("traced")
    assert ev["ts"] == pytest.approx((s["start_ns"] - base) / 1e3)


def test_record_summary_and_the_bound(monkeypatch):
    with profiling.record():
        for _ in range(3):
            with profiling.span("a"):
                time.sleep(0.001)
        with profiling.span("b", device=True):
            pass
    row = profiling.summary()
    assert list(row) == ["a", "b"] and row["a"]["count"] == 3 and row["b"]["count"] == 1
    assert row["a"]["host_ms"] >= 3.0 and "device_ms" not in row["b"]
    monkeypatch.setattr(profiling, "LIMIT", 5)
    with profiling.record():
        for i in range(3):
            with profiling.span("c", i=i):
                pass
    kept = profiling.spans()  # a ring: the two oldest went
    assert [s["name"] for s in kept] == ["a", "b", "c", "c", "c"]
    assert [s["attrs"]["i"] for s in kept[2:]] == [0, 1, 2] and profiling.dropped() == 2
    with profiling.record():
        for _ in range(5):
            with profiling.span("d"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["d"] * 5 and profiling.dropped() == 7


def test_server_spans_and_queue_stats():
    from msvit_tpu_torch.serve import BatchingServer

    w = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32))

    def apply_fn(x):
        time.sleep(0.002)
        return torch.from_numpy(x) @ w

    xs = np.random.default_rng(1).standard_normal((30, 8)).astype(np.float32)
    with BatchingServer(apply_fn, xs[0], max_batch=8, max_wait_ms=3.0) as srv:
        srv.warmup()
        with profiling.record():
            sent = []
            futs = []
            for x in xs:
                sent.append(time.monotonic())
                futs.append(srv.submit(x))
                time.sleep(0.0005)
            done = []
            for f in futs:
                f.result(timeout=30)
                done.append(time.monotonic())
            deadline = time.monotonic() + 10  # the completer closes its span
            while len(_named("serve.complete")) < len(_named("serve.batch")):
                assert time.monotonic() < deadline
                time.sleep(0.001)
        stats = srv.stats()
    batches = _named("serve.batch")
    assert sum(b["attrs"]["requests"] for b in batches) == len(xs)
    waits = [w * 1e3 for b in batches for w in b["attrs"]["waits_s"]]
    assert len(waits) == len(xs) and min(waits) >= 0
    latency_ms = (np.array(done) - np.array(sent)) * 1e3
    assert (np.array(waits) <= latency_ms).all()  # one submitter: FIFO order
    ids = {b["id"] for b in batches}
    for child in ("serve.coalesce", "serve.assemble", "serve.launch"):
        assert {s["parent"] for s in _named(child)} == ids
    for b in batches:
        assert b["attrs"]["bucket"] >= b["attrs"]["requests"]
    complete = {s["id"] for s in _named("serve.complete")}
    for child in ("serve.copy", "serve.deliver"):
        assert {s["parent"] for s in _named(child)} == complete
    rows = sum(b["attrs"]["bucket"] for b in batches)
    assert stats["pad_share"] == pytest.approx((rows - len(xs)) / rows)
    assert 0 <= stats["queue_p50_ms"] <= stats["queue_p95_ms"] <= latency_ms.max()
    assert stats["requests"] == len(xs) and stats["batches"] == len(batches)


def _tiny_multistate():
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig, MultiStateViTEncoderModel

    cfg = MultiStateViTConfig(
        hidden_size=32, num_hidden_layers=5, num_attention_heads=2, image_size=32,
        patch_size=8, pregeneration_period=2, generation_period=2,
        clustering=SpectralClusteringConfig(max_clusters=4, ncut_dim=2, num_sample=16))
    model = MultiStateViTEncoderModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    pix = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    return cfg, model, pix


def test_multistate_forwards_open_one_recluster_an_event():
    from msvit_tpu_torch.models.multistate import (
        calibrate_multistate_act_scales, quantize_multistate_params,
        quantized_multistate_apply)

    cfg, model, pix = _tiny_multistate()
    events = [i for i in range(cfg.num_hidden_layers)
              if i >= cfg.pregeneration_period and i % cfg.generation_period == 0]
    qparams = quantize_multistate_params(model)
    scales = calibrate_multistate_act_scales(qparams, cfg, pix, 0)
    with profiling.record():
        with torch.no_grad():
            model(pix, rng=3)
        quantized_multistate_apply(qparams, cfg, pix, 3, act_scales=scales)
    forwards = _named("msvit.forward")
    assert len(forwards) == 2
    for f in forwards:
        mine = [s for s in _named("msvit.recluster") if f["start_ns"] <= s["start_ns"]
                and s["end_ns"] <= f["end_ns"]]
        assert [s["attrs"]["layer"] for s in mine] == events


def test_trainer_step_opens_its_phases():
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
    from msvit_tpu_torch.train import Trainer, make_optimizer

    cfg = BaseViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                        image_size=32, patch_size=16)
    model = ViTForImageClassification(cfg, 4, generator=torch.Generator().manual_seed(0))

    def loss_fn(model, batch, generator):
        logits = model(batch["pixel_values"], generator=generator)
        return torch.nn.functional.cross_entropy(logits, batch["labels"]), {}

    g = torch.Generator().manual_seed(1)
    batch = {"pixel_values": torch.randn(2, 32, 32, 3, generator=g),
             "labels": torch.tensor([0, 3])}
    trainer = Trainer(loss_fn, make_optimizer(1e-3), model, log_every=2, monitor=True)
    with profiling.record():
        trainer.fit(iter([batch] * 3), 3, seed=0)
    steps = _named("train.step")
    assert [s["attrs"]["step"] for s in steps] == [0, 1, 2]
    for phase in ("train.forward", "train.backward", "train.update"):
        assert [s["parent"] for s in _named(phase)] == [s["id"] for s in steps]
    logs = _named("train.log")
    assert [s["parent"] for s in logs] == [steps[1]["id"], steps[2]["id"]]
    assert [s["parent"] for s in _named("sync.loss_read")] == [s["id"] for s in logs]
