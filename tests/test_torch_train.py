"""PyTorch port, training slice, against the JAX package on the CPU: the
classifier and its loss gradient (through PackedAttentionFunction, K1-lse
and K2 plain), AdamW, the train step, `Trainer` with checkpoint / resume,
the non-finite skip, EMA, `evaluate`, the augmentations' apply steps, and
remat with dropout.  Inputs are made with numpy and fed to both packages."""

import itertools
import json

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from msvit_tpu.data import augment as jaug
from msvit_tpu.eval import evaluate as j_evaluate
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base.vit import ViTForImageClassification as JCls
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu.train.loop import make_optimizer as j_make_optimizer
from msvit_tpu.train.loop import train_step_fn as j_train_step_fn
from msvit_tpu.train.trainer import Trainer as JTrainer
from msvit_tpu_torch.compat import classifier_params_from_jax
from msvit_tpu_torch.data import augment as taug
from msvit_tpu_torch.eval import evaluate
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTForImageClassification as TCls
from msvit_tpu_torch.ops import packed_attention as tpa
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import (
    CheckpointManager, Trainer, make_optimizer, train_step_fn)

# B=2, N=37 (36 patches + CLS), D=64, H=4, two layers
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             image_size=96, patch_size=16)
LABELS = 10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _classifier_pair(**kw):
    jcfg = JCfg(policy=j_parity(), **{**SMALL, **kw})
    tcfg = TCfg(policy=t_parity(), **{**SMALL, **kw})
    pix = np.random.default_rng(0).standard_normal((2, 96, 96, 3)).astype(np.float32)
    params = JCls(jcfg, num_labels=LABELS).init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(pix))
    model = TCls(tcfg, LABELS)
    model.load_state_dict(classifier_params_from_jax(params, tcfg), strict=True)
    return jcfg, params, model


def test_classifier_logits_and_grad_match_jax(monkeypatch):
    """ViTForImageClassification, parity policy: logits (1e-5 of their
    scale), CE loss (1e-5 relative) and every parameter's gradient (1e-4
    of the largest |g|) against `jax.value_and_grad`.  JAX takes its einsum
    path on the CPU; the port's packed PackedAttentionFunction, whose
    backward (K2's plain version) runs once per layer."""
    jcfg, params, model = _classifier_pair()
    rng = np.random.default_rng(2)
    pix = rng.standard_normal((2, 96, 96, 3)).astype(np.float32)
    labels = rng.integers(0, LABELS, 2)
    jmodel = JCls(jcfg, num_labels=LABELS)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(pix))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return ce.mean(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)

    calls = []
    bwd = tpa.packed_attention_bwd
    monkeypatch.setattr(tpa, "packed_attention_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    logits = model(torch.from_numpy(pix))
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert len(calls) == SMALL["num_hidden_layers"]
    assert logits.dtype == torch.float32 and logits.shape == (2, LABELS)
    np.testing.assert_allclose(
        _np(logits), _np(jlogits), rtol=0,
        atol=1e-5 * max(1.0, np.abs(_np(jlogits)).max()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = classifier_params_from_jax(jg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n in want:
        np.testing.assert_allclose(_np(got[n]), want[n].numpy(), rtol=0,
                                   atol=1e-4 * gmax, err_msg=n)


def test_remat_equals_no_remat_with_dropout():
    """Repair: with dropout and stochastic depth active, `remat=True`
    (blocks recomputed under torch.utils.checkpoint) gives the gradients of
    `remat=False` for the same generator seed: each block draws its masks
    from its own seed, so the recompute draws the same masks.  A different
    seed gives different gradients (the masks are live)."""
    kw = dict(hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.2,
              drop_path_rate=0.3)
    pix = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 96, 96, 3)).astype(np.float32))
    labels = torch.tensor([1, 7])

    def grads(remat, seed):
        model = TCls(TCfg(policy=t_parity(), remat=remat, **SMALL, **kw), LABELS)
        model.train()
        loss = F.cross_entropy(model(pix, generator=torch.Generator().manual_seed(seed)),
                               labels)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    l0, g0 = grads(False, 5)
    l1, g1 = grads(True, 5)
    l2, g2 = grads(False, 6)
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-7, msg=n)
    assert l2 != l0


# ------------------------------------------------------------ optimizer ----


class _Toy(nn.Module):
    def __init__(self, w=None, b=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(3) if w is None else torch.tensor(w))
        self.b = nn.Parameter(torch.zeros(()) if b is None else torch.tensor(b))


_TARGET = np.array([1.0, -2.0, 3.0], np.float32)


def _toy_loss_t(model, batch, gen):
    pred = batch @ model.w + model.b
    loss = ((pred - batch @ torch.from_numpy(_TARGET)) ** 2).mean()
    return loss, {"mse": loss.detach()}


def _toy_loss_j(params, batch, rng):
    pred = batch @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch @ jnp.asarray(_TARGET)) ** 2)
    return loss, {"mse": loss}


def _toy_batches(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32) for _ in itertools.count())


@pytest.mark.parametrize("frozen", [False, True])
def test_adamw_three_steps_match_optax(frozen):
    """3 steps of make_optimizer (schedule, weight decay, an optional frozen
    parameter) against the JAX package's optax.adamw: params 1e-5."""
    sched = lambda s: 0.05 * (s + 1) / 3  # noqa: E731  (float or jnp count)
    trainable = (lambda path: path[0] != "b") if frozen else None
    w0, b0 = np.array([0.5, 0.1, -0.2], np.float32), np.float32(0.3)
    jp = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    jopt = j_make_optimizer(sched, weight_decay=0.1, trainable=trainable)
    jstep = j_train_step_fn(_toy_loss_j, jopt, donate=False)
    js = jopt.init(jp)
    model = _Toy(w0, b0)
    opt = make_optimizer(sched, weight_decay=0.1, trainable=trainable)
    st = opt.init(model)
    step = train_step_fn(_toy_loss_t, opt)
    for batch in itertools.islice(_toy_batches(1), 3):
        jp, js, jl, _ = jstep(jp, js, jnp.asarray(batch), jax.random.PRNGKey(0))
        loss, _ = step(model, st, torch.from_numpy(batch), torch.Generator())
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(model.w), _np(jp["w"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(model.b), _np(jp["b"]), atol=1e-5, rtol=0)
    if frozen:
        assert float(model.b.detach()) == b0


# ------------------------------------------------------ Trainer (ports) ----


def test_trainer_converges_and_logs(tmp_path):
    """Port of tests/test_trainer.py::test_trainer_converges_and_logs
    (Adam: AdamW without decay)."""
    metrics_path = str(tmp_path / "metrics.jsonl")
    tr = Trainer(_toy_loss_t, make_optimizer(0.1, weight_decay=0.0), _Toy(),
                 metrics_path=metrics_path, log_every=10)
    batches = (torch.from_numpy(b) for b in _toy_batches())
    final = tr.fit(batches, num_steps=200, seed=0)
    assert final < 1e-2
    records = [json.loads(line) for line in open(metrics_path)]
    assert records and records[-1]["step"] == 200
    assert "mse" in records[-1]


def test_grad_accumulation_matches_full_batch():
    """Port of ::test_grad_accumulation_matches_full_batch: 4 microbatches
    give the full batch's loss, aux and update (1e-6)."""
    batch = torch.from_numpy(next(_toy_batches(7)))
    out = {}
    for m in (1, 4):
        model = _Toy()
        opt = make_optimizer(1e-2)
        loss, aux = train_step_fn(_toy_loss_t, opt, num_microbatches=m)(
            model, opt.init(model), batch, torch.Generator().manual_seed(0))
        out[m] = (float(loss), float(aux["mse"]), model.w.detach().clone())
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=1e-6)
    np.testing.assert_allclose(out[4][1], out[1][1], rtol=1e-6)
    np.testing.assert_allclose(_np(out[4][2]), _np(out[1][2]), atol=1e-6)


def test_trainer_checkpoint_resume(tmp_path):
    """Port of ::test_trainer_checkpoint_resume: a fresh Trainer restores
    step 100 with the params bit for bit."""
    ckpt = str(tmp_path / "ck")
    tr = Trainer(_toy_loss_t, make_optimizer(0.1, 0.0), _Toy(),
                 checkpoint_dir=ckpt, save_every=50)
    tr.fit((torch.from_numpy(b) for b in _toy_batches()), num_steps=100, seed=0)
    tr2 = Trainer(_toy_loss_t, make_optimizer(0.1, 0.0), _Toy(),
                  checkpoint_dir=ckpt, save_every=50)
    assert tr2.restore() == 100
    assert torch.equal(tr2.model.w, tr.model.w)


def _dropout_loss(model, batch, gen):
    """A loss that draws from the step's generator (a dropout mask)."""
    keep = (torch.rand(batch.shape, generator=gen) < 0.7).float()
    return _toy_loss_t(model, batch * keep, gen)


def test_resume_replays_the_interrupted_runs_draws(tmp_path):
    """10 steps straight equal 5 steps, a checkpoint, a fresh Trainer's
    restore and 5 more: every step's generator is seeded from (seed, step),
    and the optimizer state rides in the checkpoint (bit for bit)."""
    data = [torch.from_numpy(b) for b in itertools.islice(_toy_batches(3), 10)]
    straight = Trainer(_dropout_loss, make_optimizer(0.05), _Toy())
    straight.fit(iter(data), num_steps=10, seed=11)
    ckpt = str(tmp_path / "ck")
    first = Trainer(_dropout_loss, make_optimizer(0.05), _Toy(),
                    checkpoint_dir=ckpt, save_every=5)
    first.fit(iter(data[:5]), num_steps=5, seed=11)
    second = Trainer(_dropout_loss, make_optimizer(0.05), _Toy(),
                     checkpoint_dir=ckpt, save_every=5)
    assert second.restore() == 5
    second.fit(iter(data[5:]), num_steps=10, seed=11)
    assert torch.equal(second.model.w, straight.model.w)
    assert torch.equal(second.model.b, straight.model.b)


def _nan_loss_t(model, batch, gen):
    loss = ((batch @ model.w) ** 2).mean()
    return loss * torch.where(batch[0, 0] < 0, torch.tensor(float("nan")),
                              torch.tensor(1.0)), {}


def _nan_loss_j(params, batch, rng):
    loss = jnp.mean((batch @ params["w"]) ** 2)
    return loss * jnp.where(batch[0, 0] < 0, jnp.nan, 1.0), {}


def test_monitor_skips_nonfinite_and_reports_grad_norm(tmp_path):
    """Port of ::test_monitor_skips_nonfinite_and_reports_grad_norm, with
    NaN gradients: the bad step leaves params, both moments and the step
    count untouched; grad_norm and grads_finite reach the metrics."""
    metrics_path = str(tmp_path / "m.jsonl")
    good, bad = torch.ones(4, 3), -torch.ones(4, 3)
    tr = Trainer(_nan_loss_t, make_optimizer(0.1), _Toy([1.0, 1.0, 1.0]),
                 monitor=True, log_every=1, metrics_path=metrics_path)
    tr.fit(iter([good]), 1, seed=0)
    w1 = tr.model.w.detach().clone()
    state1 = {k: v.clone() for k, v in tr.opt_state.adamw.state[tr.model.w].items()}
    tr.metrics = None
    tr.fit(iter([bad]), 2, seed=0)
    assert torch.equal(tr.model.w, w1)  # skipped on the device
    for k, v in tr.opt_state.adamw.state[tr.model.w].items():
        assert torch.equal(v, state1[k]), k
    assert int(tr.opt_state.total_notfinite) == 1
    lines = [json.loads(line) for line in open(metrics_path)]
    assert any("grad_norm" in line for line in lines)


def _ramp(step):
    """lr = 0.1 (1 + step): a float or jnp count, or the port's device count."""
    return 0.1 * (1 + step)


_GOOD_BAD_BAD_GOOD = (0.5, -1.0, -1.0, 0.5)
_GOOD_BAD_GOOD_GOOD = (0.5, -1.0, 0.5, 0.5)


@pytest.mark.parametrize("max_nonfinite, lr, signs", [
    pytest.param(1, 0.1, _GOOD_BAD_BAD_GOOD, id="1"),
    pytest.param(3, 0.1, _GOOD_BAD_BAD_GOOD, id="3"),
    pytest.param(1, _ramp, _GOOD_BAD_GOOD_GOOD, id="schedule-1"),
    pytest.param(3, _ramp, _GOOD_BAD_GOOD_GOOD, id="schedule-3"),
])
def test_nonfinite_skip_matches_optax_apply_if_finite(max_nonfinite, lr, signs):
    """Batches of the given signs (negative: NaN loss) through both Trainers
    with monitor: params as in JAX (optax.apply_if_finite) after every step,
    1e-5 (the AdamW bar).  At max_nonfinite=1, good, bad, bad, good applies
    the second bad step (NaN params), as optax does.  With the schedule
    lr = 0.1 (1 + step) a skipped step must not advance the schedule's
    count: optax reads it at the inner count of applied steps."""
    seq = [np.ones((4, 3), np.float32) * s for s in signs]
    jt = JTrainer(_nan_loss_j, optax.adamw(lr, weight_decay=0.01), {"w": jnp.ones(3)},
                  monitor=True, max_nonfinite=max_nonfinite, donate=False)
    tt = Trainer(_nan_loss_t, make_optimizer(lr, weight_decay=0.01),
                 _Toy([1.0, 1.0, 1.0]), monitor=True, max_nonfinite=max_nonfinite)
    for i, b in enumerate(seq):
        jt.fit(iter([jnp.asarray(b)]), i + 1, jax.random.PRNGKey(0))
        tt.fit(iter([torch.from_numpy(b)]), i + 1, seed=0)
        want = np.asarray(jt.params["w"])
        np.testing.assert_allclose(_np(tt.model.w), want, atol=1e-5, rtol=0,
                                   err_msg=f"step {i}")
    nan_run = max_nonfinite == 1 and signs == _GOOD_BAD_BAD_GOOD
    assert np.isnan(_np(tt.model.w)).any() == nan_run
    applied = sum(s > 0 for s in signs) + nan_run
    assert tt.opt_state.count.dtype == torch.int32
    assert int(tt.opt_state.count) == applied


def test_schedule_count_survives_resume(tmp_path):
    """Good, bad (skipped), good under lr = 0.1 (1 + step), checkpointed;
    a new Trainer restores the count of applied steps (2, not the 3 steps
    taken), and its next step equals the uninterrupted run's.  A state
    dict of the older format, whose "count" is a host int, loads with that
    int as the applied count."""
    good, bad = torch.ones(4, 3) * 0.5, -torch.ones(4, 3)
    ckpt = str(tmp_path / "ckpt")

    def trainer(**kw):
        return Trainer(_nan_loss_t, make_optimizer(_ramp, weight_decay=0.01),
                       _Toy([1.0, 1.0, 1.0]), monitor=True, max_nonfinite=3, **kw)

    ref = trainer()
    ref.fit(iter([good, bad, good, good]), 4, seed=0)
    tr = trainer(checkpoint_dir=ckpt, save_every=3)
    tr.fit(iter([good, bad, good]), 3, seed=0)
    assert int(tr.opt_state.count) == 2
    tr2 = trainer(checkpoint_dir=ckpt)
    assert tr2.restore() == 3
    assert isinstance(tr2.opt_state.count, torch.Tensor)
    assert int(tr2.opt_state.count) == 2
    assert int(tr2.opt_state.total_notfinite) == 1
    tr2.fit(iter([good]), 4, seed=0)
    assert int(tr2.opt_state.count) == 3
    assert torch.equal(tr2.model.w, ref.model.w)

    state = tr2.opt_state.state_dict()
    state["count"] = 7
    tr2.opt_state.load_state_dict(state)
    assert tr2.opt_state.count.dtype == torch.int32
    assert int(tr2.opt_state.count) == 7


def test_trainer_ema_tracks_params(tmp_path):
    """Port of ::test_trainer_ema_tracks_params: the EMA equals a
    hand-rolled one, is checkpointed and restores on resume."""
    decay = 0.9

    def batch_at(i):
        return torch.from_numpy(next(_toy_batches(100 + i)))

    tr_ref = Trainer(_toy_loss_t, make_optimizer(0.1, 0.0), _Toy())
    ema_ref = tr_ref.model.w.detach().clone()
    for i in range(5):
        tr_ref.fit(iter([batch_at(i)]), num_steps=i + 1, seed=0)
        ema_ref = decay * ema_ref + (1 - decay) * tr_ref.model.w.detach()
    ckpt_dir = str(tmp_path / "ckpt")
    tr = Trainer(_toy_loss_t, make_optimizer(0.1, 0.0), _Toy(), ema_decay=decay,
                 checkpoint_dir=ckpt_dir, save_every=5)
    tr.fit(iter([batch_at(i) for i in range(5)]), num_steps=5, seed=0)
    np.testing.assert_allclose(_np(tr.ema_params["w"]), _np(ema_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tr.model.w), _np(tr_ref.model.w),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(_np(tr.ema_params["w"]), _np(tr.model.w))
    tr2 = Trainer(_toy_loss_t, make_optimizer(0.1, 0.0), _Toy(), ema_decay=decay,
                  checkpoint_dir=ckpt_dir)
    assert tr2.restore() == 5
    assert torch.equal(tr2.ema_params["w"], tr.ema_params["w"])


def test_checkpoint_manager_keeps_newest_and_writes_atomically(tmp_path):
    """Asynchronous saves, one in flight, the newest max_to_keep kept; a
    host snapshot is taken at save time (later in-place updates do not
    reach it)."""
    mgr = CheckpointManager(str(tmp_path), save_every=2, max_to_keep=2)
    t = torch.zeros(4)
    for step in range(1, 9):
        t += 1
        mgr.maybe_save(step, {"t": t, "step": step})
    mgr.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_6.pt", "ckpt_8.pt"]
    step, state = mgr.restore_latest()
    assert step == 8 and state["step"] == 8 and torch.equal(state["t"], torch.full((4,), 8.0))


# ----------------------------------------------------------------- eval ----


def test_evaluate_matches_jax():
    """`evaluate` against the JAX package's on the same logits (x @ W),
    padded last batch: n exact, accuracies exact, loss 1e-5 relative."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 10)).astype(np.float32)
    xs = rng.standard_normal((50, 8)).astype(np.float32)
    ys = rng.integers(0, 10, size=(50,))
    batches = [{"pixel_values": xs[i:i + 16], "labels": ys[i:i + 16]}
               for i in range(0, 50, 16)]
    want = j_evaluate(lambda p, x: x @ p, jnp.asarray(w), batches, topk=(1, 5))
    model = nn.Linear(8, 10, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T.copy()))
    got = evaluate(lambda m, x: m(x), model, batches, topk=(1, 5))
    assert set(got) == set(want) and got["n"] == 50
    for k in ("top1_acc", "top5_acc"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-7)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)


# -------------------------------------------------------------- augment ----


def _img(seed=0, b=4, h=12, w=10):
    return np.random.default_rng(seed).standard_normal((b, h, w, 3)).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_augment_apply_steps_match_jax():
    """Each apply step, given JAX's own draws (made with the same key
    splits as the JAX functions), reproduces the JAX function's output."""
    x = _img()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(3)
    b, h, w = 4, 12, 10

    flip = jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))
    _close(taug.apply_flip(tx, {"flip": torch.tensor(np.asarray(flip).reshape(b))}),
           jaug.random_flip(key, jx))

    kb, kc = jax.random.split(key)
    bf = 1.0 + jax.random.uniform(kb, (b, 1, 1, 1), minval=-0.2, maxval=0.2)
    cf = 1.0 + jax.random.uniform(kc, (b, 1, 1, 1), minval=-0.2, maxval=0.2)
    draws = {"brightness": torch.tensor(np.asarray(bf).reshape(b)),
             "contrast": torch.tensor(np.asarray(cf).reshape(b))}
    _close(taug.apply_brightness_contrast(tx, draws),
           jaug.random_brightness_contrast(key, jx), atol=1e-5)

    ka, ky, kx, kp = jax.random.split(key, 4)
    draws = {"area": jax.random.uniform(ka, (b,), minval=0.02, maxval=0.2),
             "y": jax.random.uniform(ky, (b,)), "x": jax.random.uniform(kx, (b,)),
             "apply": jax.random.bernoulli(kp, 0.5, (b, 1, 1)).reshape(b)}
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    _close(taug.apply_erasing(tx, draws), jaug.random_erasing(key, jx))

    labels = np.array([1, 3, 0, 2])
    kl, _ = jax.random.split(key)
    lam = torch.tensor(np.asarray(jax.random.beta(kl, 0.2, 0.2, (b,))))
    gm, gt = taug.apply_mixup(tx, torch.from_numpy(labels), {"lam": lam}, 5)
    wm, wt = jaug.mixup(key, jx, jnp.asarray(labels), 5)
    _close(gm, wm, atol=1e-5)
    _close(gt, wt)

    kl, ky, kx = jax.random.split(key, 3)
    draws = {"lam": jax.random.beta(kl, 1.0, 1.0, (b,)),
             "y": jax.random.uniform(ky, (b,)), "x": jax.random.uniform(kx, (b,))}
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    gm, gt = taug.apply_cutmix(tx, torch.from_numpy(labels), draws, 5)
    wm, wt = jaug.cutmix(key, jx, jnp.asarray(labels), 5)
    _close(gm, wm)
    _close(gt, wt)


def test_augment_draws_are_seeded_and_shaped():
    """The random_* functions draw from the generator they are given: the
    same seed gives the same result, and the outputs keep the shapes."""
    x = torch.from_numpy(_img(1))
    labels = torch.tensor([0, 1, 2, 3])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        y = taug.random_erasing(g, taug.random_brightness_contrast(g, taug.random_flip(g, x)))
        m, t = taug.mixup(g, y, labels, 4)
        c, u = taug.cutmix(g, m, t)
        return c, u

    a, b = run(0), run(0)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert a[0].shape == x.shape and a[1].shape == (4, 4)
    np.testing.assert_allclose(_np(a[1]).sum(-1), 1.0, atol=1e-6)
    assert not torch.equal(run(1)[0], a[0])
