"""The readers of the program's spans against a synthetic window: the
device's idle gaps and the spans a program recorded, by hand; and nothing
read from a program that keeps no spans, as one from before the recorder."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from msvit_tpu_torch.utils import profiling
from perfbench import spans, spec

MS = 1_000_000  # ns
T0 = 10**18  # the window's start on the profiler's clock
NEW = ["serve.queue_p95_ms", "serve.idle_holding_pct", "serve.pad_pct",
       "idle_clustering_pct.infer", "host_syncs_per_batch.infer", "forward_ms.train",
       "backward_ms.train", "update_ms.train"]


def _run(gaps_ms, host=()):
    """A traced window of 100 ms whose device was idle in `gaps_ms`, with
    the host operations `host` (name, start ms)."""
    gaps = [(T0 + a * MS, T0 + b * MS) for a, b in gaps_ms]
    host = [(T0 + int(a * MS), T0 + int(a * MS) + 1000, name) for name, a in host]
    trace = SimpleNamespace(t0=T0, t1=T0 + 100 * MS, window_s=0.1, gaps=gaps, host=host,
                            busy_s=0.1 - sum(b - a for a, b in gaps) / 1e9)
    return SimpleNamespace(trace=trace, counts={})


def _span(i, name, a_ms, b_ms, parent=None, **extra):
    return dict({"name": name, "start_ns": T0 + int(a_ms * MS), "end_ns": T0 + int(b_ms * MS),
                 "thread": 1, "id": i, "parent": parent, "attrs": {}}, **extra)


@pytest.fixture
def recorded(monkeypatch):
    """Hands the readers these spans as the program's."""
    def use(items):
        monkeypatch.setattr(profiling, "spans",
                            lambda since_ns=0: [s for s in items if s["end_ns"] >= since_ns])
    return use


def read(metric, run):
    return spec.reader(metric).read(run)


def test_serve_readers(recorded):
    # batch 1 began before the window (only its launch is inside); batch 2
    # holds two requests from 10 to 30 ms and launches to 40; batch 3 one
    # request, 60-70 held, launched to 75
    recorded([
        _span(1, "serve.batch", -20, 5, attrs={"bucket": 64, "requests": 64,
                                               "waits_s": [0.099] * 64}),
        _span(2, "serve.launch", -5, 5, parent=1),
        _span(3, "serve.batch", 10, 40, attrs={"bucket": 4, "requests": 2,
                                               "waits_s": [0.001, 0.003]}),
        _span(4, "serve.coalesce", 10, 25, parent=3),
        _span(5, "serve.launch", 30, 40, parent=3),
        _span(6, "serve.batch", 60, 75, attrs={"bucket": 1, "requests": 1,
                                               "waits_s": [0.002]}),
        _span(7, "serve.launch", 70, 75, parent=6),
        _span(8, "serve.complete", 40, 50),
    ])
    run = _run([(0, 2), (20, 35), (50, 65), (90, 100)])
    assert read("serve.queue_p95_ms", run) == pytest.approx(2.9)  # of 1, 2, 3
    assert read("serve.pad_pct", run) == pytest.approx(100 * 2 / 5)
    # idle while held: 20-30 of batch 2, 60-65 of batch 3; batch 1 was
    # launching at 0-2
    assert read("serve.idle_holding_pct", run) == pytest.approx(15.0)
    assert read("serve.idle_holding_pct", run) <= 100 * (2 + 15 + 15 + 10) / 100


def test_clustering_readers(recorded):
    recorded([
        _span(1, "msvit.forward", 0, 45),
        _span(2, "msvit.recluster", 5, 15, parent=1, attrs={"layer": 4}),
        _span(3, "sync.eigh", 8, 9, parent=2),
        _span(4, "msvit.recluster", 12, 25, parent=1, attrs={"layer": 6}),
        _span(5, "sync.eigh", 20, 21, parent=4),
        _span(6, "msvit.forward", 50, 95),
        _span(7, "msvit.recluster", 60, 70, parent=6, attrs={"layer": 4}),
        _span(8, "sync.eigh", 61, 62, parent=7),
        _span(9, "sync.eigh", 99, 101),  # began in the window
        _span(10, "sync.eigh", 100, 101),  # after it
    ])
    sync = "cudaStreamSynchronize"
    host = [(sync, 8.5), ("cudaMemcpyAsync", 8.2), (sync, 20.5), ("cudaEventSynchronize", 30),
            ("cudaMemcpy", 61.5), ("cudaDeviceSynchronize", 90), ("aten::item", 8.4),
            (sync, 47)]  # the last between the forwards
    run = _run([(0, 6), (10, 20), (24, 30), (65, 80)], host)
    # idle under the union of 5-25 and 60-70: 5-6, 10-20, 24-25, 65-70
    assert read("idle_clustering_pct.infer", run) == pytest.approx(17.0)
    # the runtime's syncs inside the two forwards, whatever the sync.* spans say
    assert read("host_syncs_per_batch.infer", run) == pytest.approx(5 / 2)
    assert read("host_syncs_per_batch.infer", _run([], [("aten::mm", 5)])) == 0.0
    recorded([_span(1, "msvit.forward", -5, 45)])  # not wholly in the window
    assert read("host_syncs_per_batch.infer", run) is None


def test_train_readers(recorded):
    items, i = [], 0
    for step, a in enumerate((-30, 10, 40, 70)):  # the first began before the window
        items.append(_span(i, "train.step", a, a + 28, attrs={"step": step}))
        items += [_span(i + 1, "train.forward", a, a + 5, parent=i, device_ms=10.0),
                  _span(i + 2, "train.backward", a + 5, a + 15, parent=i, device_ms=20.0),
                  _span(i + 3, "train.update", a + 15, a + 16, parent=i, device_ms=1.5)]
        i += 4
    items.append(_span(i, "train.step", 99, 101))  # a step without its device spans yet
    recorded(items)
    run = _run([])
    assert read("forward_ms.train", run) == pytest.approx(3 * 10.0 / 4)
    assert read("backward_ms.train", run) == pytest.approx(3 * 20.0 / 4)
    assert read("update_ms.train", run) == pytest.approx(3 * 1.5 / 4)


def test_idle_under_overlapping_intervals():
    run = _run([(0, 10), (20, 30), (40, 50)])
    held = [(T0 + 5 * MS, T0 + 25 * MS), (T0 + 8 * MS, T0 + 22 * MS), (T0 + 45 * MS, T0 + 60 * MS)]
    assert spans.idle_seconds_under(run, held) == pytest.approx((5 + 5 + 5) / 1e3)
    assert spans.union([(3, 4), (1, 2), (2, 3), (6, 6)]) == [(1, 4)]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read(metric, recorded, monkeypatch):
    assert read(metric, SimpleNamespace(trace=None, counts={})) is None
    recorded([])  # a recorder that recorded nothing
    assert read(metric, _run([(0, 100)])) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert read(metric, _run([(0, 100)])) is None


def test_the_new_metrics_are_declared():
    declared = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    assert set(NEW) <= set(declared)
    for name in NEW:
        assert declared[name]["workloads"]


def test_span_clock_leads(recorded):
    from perfbench.tools import span_clock

    recorded([
        _span(1, "serve.launch", 10, 12),  # the device idle at 10: its batch begins at 11
        _span(2, "serve.launch", 30, 31),  # busy at 30: not a first activity
        _span(3, "serve.device_wait", 40, 52),  # the batch ended at 50
    ])
    run = _run([(0, 11), (50, 60)])
    run.trace.device = [(T0 + 11 * MS, T0 + 20 * MS, "k"), (T0 + 20 * MS, T0 + 50 * MS, "k")]
    launch, wait = span_clock.leads(run)
    assert launch == [pytest.approx(1000.0)] and wait == [pytest.approx(2000.0)]


def test_span_clock_account(recorded):
    from perfbench.tools import span_clock

    recorded([
        _span(1, "train.step", -10, 30),  # began before the window: not counted
        _span(2, "train.step", 40, 90),
        _span(3, "train.update", 80, 90, parent=2, device_ms=4.0),
    ])
    got = span_clock.account(_run([(85, 100)]))
    assert got == {"train.step": {"count": 1, "host_s": pytest.approx(0.05),
                                  "idle_s": pytest.approx(0.005)},
                   "train.update": {"count": 1, "host_s": pytest.approx(0.01),
                                    "idle_s": pytest.approx(0.005),
                                    "device_s": pytest.approx(0.004)}}


def test_span_clock_syncs(recorded):
    from perfbench.tools import span_clock

    recorded([
        _span(1, "msvit.forward", 0, 40),
        _span(2, "sync.eigh", 10, 12, parent=1),
        _span(3, "sync.key_words", 20, 22, parent=1),
        _span(4, "msvit.forward", 50, 90),
        _span(5, "sync.eigh", 60, 62, parent=4),
    ])
    sync = "cudaStreamSynchronize"
    run = _run([], [(sync, 11), (sync, 21), (sync, 61), (sync, 70), (sync, 45)])
    assert span_clock.syncs(run) == {
        "forwards": 2, "runtime_per_forward": 2.0, "spans_per_forward": 1.5,
        "runtime_by_span": {"none": 0.5, "sync.eigh": 1.0, "sync.key_words": 0.5}}
    recorded([])
    assert span_clock.syncs(run) is None
