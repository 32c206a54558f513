"""Each cell's loop at a tiny size on the CPU, against the reference and
the cell's limits; the control and each planted fault that the comparison
has to reject; the run's refusals.

The loops run their plain paths here (no card); on the card the same
loops run the kernels.  Planted faults break the program underneath the
loop, where the timed path computes its answers."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import spec
from perfbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ROOT = str(spec.ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_agrees_with_the_reference(name):
    out, ok = tiny.run(name)
    assert ok, tiny.dumps(out["check"])
    assert out["attempted"] > 0 and out["failed"] == 0
    (metric, value), = out["metrics"].items()
    assert value > 0 and metric in [m["name"] for m in spec.end_to_end(spec.benchmark(), name)]


def test_tiny_multistate_run_clusters():
    """The tiny scenes split: the partition check compares more than one
    cluster."""
    from perfbench import compare

    seen = []
    real = compare.multistate

    def spy(sd, cfg, pool, seeds, outputs, events):
        seen.extend(int(nc) for _, _, _, nc in outputs)
        return real(sd, cfg, pool, seeds, outputs, events)

    compare.multistate = spy
    try:
        tiny.run("msvit-b8.int8-bs32")
    finally:
        compare.multistate = real
    assert max(seen) > 1


def _altered(fn, where):
    """fn with its answer for the first image negated."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        t = (out if where is None else out[where]).clone()
        t[0] = -t[0]
        return t if where is None else dict(out, **{where: t})
    return broken


def _serving_apply():
    from msvit_tpu_torch.models.base import quantized
    return quantized, "quantized_vit_apply", None


def _int8_multistate_apply():
    from msvit_tpu_torch.models import multistate
    return multistate, "quantized_multistate_apply", "last_hidden_state"


def _bf16_multistate_forward():
    from msvit_tpu_torch.models.multistate.model import MultiStateViTEncoderModel
    return MultiStateViTEncoderModel, "forward", "last_hidden_state"


@pytest.mark.parametrize("name,where", [
    ("vit-b16.int8-serve", _serving_apply),
    ("msvit-b8.int8-bs32", _int8_multistate_apply),
    ("msvit-b8.bf16-bs32", _bf16_multistate_forward),
])
def test_an_answer_altered_where_produced_is_not_correct(monkeypatch, name, where):
    owner, attr, key = where()
    monkeypatch.setattr(owner, attr, _altered(getattr(owner, attr), key))
    out, ok = tiny.run(name)
    assert not ok, tiny.dumps(out["check"])


def test_a_partition_altered_is_not_correct(monkeypatch):
    from msvit_tpu_torch.models.multistate import model

    inner = model.cluster

    def swapped(*args, **kwargs):
        child, n_children = inner(*args, **kwargs)
        return torch.where(child == 0, 1, torch.where(child == 1, 0, child)), n_children

    monkeypatch.setattr(model, "cluster", swapped)
    out, ok = tiny.run("msvit-b8.int8-bs32")
    assert not ok and out["check"]["partition_differs"] > 0, tiny.dumps(out["check"])


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from msvit_tpu_torch.train import loop

    monkeypatch.setattr(loop.OptState, "update", lambda self, finite: None)
    out, ok = tiny.run("vit-b16.train-bs256")
    assert not ok and out["check"]["update_gap"] > 0.9, tiny.dumps(out["check"])


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from msvit_tpu_torch.train import trainer

    real = trainer.train_step_fn

    def half(*args, **kwargs):
        step = real(*args, **kwargs)

        def halved(model, opt_state, batch, generator, ema=None):
            n = len(batch["labels"]) // 2
            return step(model, opt_state, {k: v[:n] for k, v in batch.items()},
                        generator, ema)
        return halved

    monkeypatch.setattr(trainer, "train_step_fn", half)
    out, ok = tiny.run("vit-b16.train-bs256")
    assert not ok, tiny.dumps(out["check"])


def _from_the_window(monkeypatch, wrap):
    """Every train step from the fourth on (the window's) replaced by
    wrap(step, model, opt_state, batch, generator, ema)."""
    from perfbench.loops import train_closed
    from msvit_tpu_torch.train import trainer

    real = trainer.train_step_fn

    def planted(*args, **kwargs):
        step, taken = real(*args, **kwargs), []

        def maybe(model, opt_state, batch, generator, ema=None):
            taken.append(1)
            if len(taken) <= train_closed.FIRST_STEPS:
                return step(model, opt_state, batch, generator, ema)
            return wrap(step, model, opt_state, batch, generator, ema)
        return maybe

    monkeypatch.setattr(trainer, "train_step_fn", planted)


def _unchanged(step, model, opt_state, batch, generator, ema):
    """The step computed, its update undone."""
    before = [p.detach().clone() for p in model.parameters()]
    out = step(model, opt_state, batch, generator, ema)
    with torch.no_grad():
        for p, b in zip(model.parameters(), before):
            p.copy_(b)
    return out


def _halved(step, model, opt_state, batch, generator, ema):
    n = len(batch["labels"]) // 2
    return step(model, opt_state, {k: v[:n] for k, v in batch.items()}, generator, ema)


def _poisoned(step, model, opt_state, batch, generator, ema):
    """A non-finite pixel: the monitored step skips the batch."""
    pix = batch["pixel_values"].clone()
    pix[0, 0, 0, 0] = float("nan")
    return step(model, opt_state, dict(batch, pixel_values=pix), generator, ema)


@pytest.mark.parametrize("wrap,number", [
    (_unchanged, "window_update_gap"),
    (_halved, "window_grad_gap"),
    (_poisoned, "skipped_steps"),
])
def test_a_fault_from_the_window_on_is_not_correct(monkeypatch, wrap, number):
    """Set-up's steps sound, the window's steps broken: the state left as
    it was, half of each batch left out, or each step skipped."""
    _from_the_window(monkeypatch, wrap)
    out, ok = tiny.run("vit-b16.train-bs256")
    limits = spec.limits("vit-b16.train-bs256")
    assert not ok and out["check"][number] > limits[number]["limit"], tiny.dumps(out["check"])
    assert out["check"]["update_gap"] <= limits["update_gap"]["limit"]


def test_clustering_events_the_hook_misses_are_not_correct(monkeypatch):
    from perfbench import programs

    real = programs.ClusteringRecorder.begin

    def forgetful(self, slot):
        real(self, slot)
        self._slot = None  # the events of this forward go unseen

    monkeypatch.setattr(programs.ClusteringRecorder, "begin", forgetful)
    out, ok = tiny.run("msvit-b8.bf16-bs32")
    assert not ok and out["check"]["clusters_differ"] > 0, tiny.dumps(out["check"])


def test_features_altered_at_a_clustering_event_are_not_correct(monkeypatch):
    """The features the bf16 forward hands its clustering events, off by a
    tenth while the trunk runs on unchanged, fail `features_rel_err` alone:
    clustering is judged on the features it was given."""
    from msvit_tpu_torch.models.multistate import model

    inner = model.recluster

    def off(config, hidden, *args):
        return inner(config, hidden * 1.1, *args)

    monkeypatch.setattr(model, "recluster", off)
    out, ok = tiny.run("msvit-b8.bf16-bs32")
    limits = spec.limits("msvit-b8.bf16-bs32")
    assert not ok and out["check"]["features_rel_err"] > limits["features_rel_err"]["limit"], \
        tiny.dumps(out["check"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference one precision step below the configuration's, in the
    program's place, fails the cell's comparison (`tools/controls.py` reads
    it at the cell's size on the card)."""
    from perfbench.tools import controls

    c, config, traffic = tiny.cell(name)
    if traffic["loop"] in ("serve_open", "train_closed"):
        # the control's gaps grow with the widths: int4 crosses the int8
        # serving tolerance, and fp8 a training limit, at the published
        # widths (two layers here), not at the tiny ones
        config = dict(spec.config(spec.benchmark(), c["config"]), num_hidden_layers=2)
    if traffic["loop"] == "train_closed":
        traffic = dict(traffic, batch=16, log_every=4)
    limits = spec.limits(name)
    read = getattr(controls, traffic["loop"])
    numbers = read(config, traffic, 2**33 + 3, limits["control"], torch.device("cpu"))
    assert any(v > limits[k]["limit"] for k, v in numbers.items()), tiny.dumps(numbers)


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    done = _python(
        "from perfbench.tests import tiny\n"
        "from perfbench.run import forbidden_modules\n"
        "import sys\n"
        "for name in sys.argv[1:] or " + repr(CELLS) + ":\n"
        "    tiny.run(name)\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    assert done.returncode == 0, done.stderr[-2000:]
    assert "FORBIDDEN []" in done.stdout


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
                           "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert not any(line.startswith("{") for line in done.stdout.splitlines())


def test_an_unknown_workload_is_refused():
    done = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "nope",
                           "--seed", "1", "--seconds", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "no workload" in done.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name,
                           "--seed", str(2**40 + 1), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu" and list(result)[-1] == "check"
