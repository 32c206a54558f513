"""PyTorch port, the predictive family against the JAX package (CPU): both
grid samplers with their gradients, the configs, the conv encoder and the
transposed-conv decoder alone, the model for every patch config, each of
the seven losses, `training_loss` and its gradients, `patch_mean_bar`,
two AdamW steps against optax, the three defect rulings, and the
example's CLI.  Weights are converted by `predictive_params_from_jax`;
the glimpses draw JAX's numbers through `JaxRng`.  f32 throughout."""

import dataclasses
import functools
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import predictive as jp
from msvit_tpu.models.predictive import losses as jl
from msvit_tpu.ops import grid_sample as jgs
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import predictive_params_from_jax
from msvit_tpu_torch.examples import train_predictive_synthetic as ex
from msvit_tpu_torch.models import predictive as tp
from msvit_tpu_torch.models.predictive import losses as tl
from msvit_tpu_torch.ops import grid_sample as tgs
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import make_optimizer, train_step_fn
from test_torch_clustering import JaxRng


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


# -------------------------------------------------------- grid sampling ----

_MODES = [(m, p) for m in ("bicubic", "bilinear", "nearest") for p in ("border", "zeros")]


@pytest.mark.parametrize("mode,padding", _MODES)
def test_grid_sample_matches_jax(mode, padding):
    """Arbitrary points, some outside the image: values within 1e-5, the
    gradients of a weighted sum for the image and the points within 1e-4
    of their largest magnitude (`jax.grad`; f32 sums of tens)."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 4, 2)).astype(np.float32)
    wts = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)

    def jf(i, g):
        return jnp.sum(jgs.grid_sample(i, g, mode, padding) * wts)

    want = jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode, padding)
    jgi, jgg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti = torch.from_numpy(img).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    got = tgs.grid_sample(ti, tg, mode, padding)
    (got * torch.from_numpy(wts)).sum().backward()
    assert got.shape == want.shape == (2, 5, 4, 3)
    _close(got, want, 1e-5)
    _close(ti.grad, jgi, 1e-4 * max(1.0, float(np.abs(jgi).max())), "image")
    _close(tg.grad, jgg, 1e-4 * max(1.0, float(np.abs(jgg).max())), "points")


@pytest.mark.parametrize("mode,padding", _MODES)
def test_grid_sample_separable_matches_jax(mode, padding):
    """Axis-aligned lattices [B, S, Py, Px]: values within 1e-5 of JAX's
    separable sampler (and of the port's general one on the same lattice),
    gradients for the image and both coordinate axes within 1e-4 of their
    largest magnitude (f32 sums of tens)."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 10, 12, 3)).astype(np.float32)
    ys = rng.uniform(-1.2, 1.2, (2, 3, 5)).astype(np.float32)
    xs = rng.uniform(-1.2, 1.2, (2, 3, 6)).astype(np.float32)
    wts = rng.standard_normal((2, 3, 5, 6, 3)).astype(np.float32)

    def jf(i, y, x):
        return jnp.sum(jgs.grid_sample_separable(i, y, x, mode, padding) * wts)

    want = jgs.grid_sample_separable(*(jnp.asarray(t) for t in (img, ys, xs)), mode, padding)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (img, ys, xs)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (img, ys, xs)]
    got = tgs.grid_sample_separable(*leaves, mode, padding)
    (got * torch.from_numpy(wts)).sum().backward()
    assert got.shape == want.shape == (2, 3, 5, 6, 3)
    _close(got, want, 1e-5)
    for t, j, name in zip(leaves, jgrads, ("image", "ys", "xs")):
        # nearest: no gradient path to the coordinates here, zeros in JAX
        g = torch.zeros_like(t) if t.grad is None else t.grad
        _close(g, j, 1e-4 * max(1.0, float(np.abs(j).max())), name)
    lattice = torch.stack(torch.broadcast_tensors(
        torch.from_numpy(xs)[:, :, None, :], torch.from_numpy(ys)[:, :, :, None]), -1)
    _close(tgs.grid_sample(torch.from_numpy(img), lattice, mode, padding), want, 1e-5)


# -------------------------------------------------------------- configs ----


def test_configs_match_jax():
    assert tp.PATCH_CONFIG_DOF == jp.PATCH_CONFIG_DOF
    for name in ("PredictiveViTConfig", "PredictiveViTTrainingConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jp, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tp, name))]
        for (n, jd), (tn, td) in zip(jf, tf):
            assert n == tn
            if n == "policy":
                assert dataclasses.asdict(jd) == dataclasses.asdict(td)
            else:
                assert jd == td, n
        assert len(jf) == len(tf)
    assert tp.PredictiveViTConfig().seq_length == jp.PredictiveViTConfig().seq_length


# ------------------------------------------------------------- the model ----

GEOM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=64,
            patch_size=16, max_context_length=3)
SANDBOX = dict(use_cls_token=False, patch_config="scaling", default_patch_scale=0.4,
               patch_config_scale=((1.0, 0.0), (1.0, 0.0), (1.0, -1.0)))
_PATCH_CONFIGS = {
    "translation": dict(patch_config="translation", pe_bias=True),
    "scaling": SANDBOX,
    "non-uniform-scaling": dict(patch_config="non-uniform-scaling", patch_config_scale=0.8),
}


@functools.lru_cache(maxsize=None)
def _pair(kind="scaling"):
    """JAX `PredictiveViTModel` params and the port's model loaded with them
    (shared by the tests: the port's model is only read)."""
    kw = {**GEOM, **_PATCH_CONFIGS[kind]}
    jcfg, tcfg = jp.PredictiveViTConfig(policy=j_parity(), **kw), \
        tp.PredictiveViTConfig(policy=t_parity(), **kw)
    model = jp.PredictiveViTModel(jcfg)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "glimpse": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))
    tmodel = tp.PredictiveViTModel(tcfg)
    tmodel.load_state_dict(predictive_params_from_jax(variables, tcfg), strict=True)
    return model, variables, tmodel


def _pixels(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 64, 64, 3)).astype(np.float32)


def test_latent_to_patch_matches_jax():
    """The transposed-conv decoder alone (lax's "SAME"/"VALID" padding,
    the unflipped kernel): within 1e-5 of JAX's output's scale."""
    model, variables, tmodel = _pair()
    lat = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(lat),
                       method=lambda m, x: m.patch_embeddings.latent_to_patch(x))
    with torch.no_grad():
        got = tmodel.patch_embeddings.latent_to_patch(torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 3, 16, 16, 3)
    _close(got, want, 1e-5 * float(np.abs(want).max()))


def test_patch_to_latent_matches_jax():
    model, variables, tmodel = _pair()
    patches = np.random.default_rng(2).standard_normal((2, 3, 16, 16, 3)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(patches),
                       method=lambda m, x: m.patch_embeddings.patch_to_latent(x))
    with torch.no_grad():
        got = tmodel.patch_embeddings.patch_to_latent(torch.from_numpy(patches))
    assert got.shape == want.shape == (2, 3, 64)
    _close(got, want, 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", list(_PATCH_CONFIGS))
def test_model_matches_jax(kind):
    """The forward for each patch config, the lengths and positions drawn
    from JAX's numbers: context lengths and positions equal, the sample
    lattice within 1e-6, embeddings and last_hidden_state within 1e-3."""
    model, variables, tmodel = _pair(kind)
    pix = _pixels(3)
    key = jax.random.PRNGKey(4)
    want = jax.jit(functools.partial(model.apply, output_inputs=True))(
        variables, jnp.asarray(pix), rng=key)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pix), rng=JaxRng(key), output_inputs=True)
    np.testing.assert_array_equal(got["context_lengths"].numpy(),
                                  np.asarray(want["context_lengths"]))
    np.testing.assert_array_equal(_np(got["input_position"]), _np(want["input_position"]))
    pts = model.apply(variables, want["input_position"],
                      method=lambda m, c: m.patch_embeddings.grid_sample_points(c))
    _close(tmodel.patch_embeddings.grid_sample_points(got["input_position"]), pts, 1e-6)
    _close(got["input_hidden_state"], want["input_hidden_state"], 1e-3)
    _close(got["last_hidden_state"], want["last_hidden_state"], 1e-3)


def test_key_mask_takes_the_plain_attention_path(monkeypatch):
    """The trunk's key mask [B, 1, 1, N] at N = max_context_length + 2: the
    packed path refuses it and "auto" keeps the plain attention (N < 512)."""
    _, _, tmodel = _pair()
    seen = []
    attn = tmodel.encoder.layer[0].attention
    orig = attn._use_packed

    def spy(x, ctx, mask, probs):
        seen.append((tuple(mask.shape), orig(x, ctx, mask, probs)))
        return seen[-1][1]

    monkeypatch.setattr(attn, "_use_packed", spy)
    with torch.no_grad():
        tmodel(torch.from_numpy(_pixels()), rng=0)
    assert seen == [((2, 1, 1, 5), False)]


# -------------------------------------------------------------- losses ----

_ALL7 = dict(preservation=1.0, context_prediction=1.0, query_prediction=1.0,
             context_patch_prediction=1e-4, query_patch_prediction=1.0,
             positional_recovery=1.0, positional_regularization=0.5)


def _jax_loss(model, variables, pix, key, tc, name=None):
    """(mean loss, (per-loss dict, meta, output)) of JAX's training loss, or
    of the one loss `name`, and its gradients (`jax.value_and_grad`,
    jitted)."""
    return _jax_value_and_grad(model, tc, name)(variables, pix, key)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(model, tc, name):
    def f(v, pix, key):
        out = model.apply(v, pix, rng=key, output_inputs=True)
        if name is None:
            err, losses, meta = jl.training_loss(model, v, pix, out, tc)
            return jnp.mean(err), (losses, meta, out)
        err, meta = jl.LOSS2FN[name](model, v, pix, out)
        return jnp.mean(err), ({name: err}, meta, out)
    return jax.jit(jax.value_and_grad(f, has_aux=True))


# biases added to every token just before a standardisation over (batch,
# tokens): their gradient is zero but for f32 noise, in both packages
_DEAD = ("patch_embeddings.enc_dense.bias", "encoder.layer.1.mlp.fc2.bias")


def _noise(g: torch.Tensor, weight_grad: torch.Tensor) -> bool:
    return float(g.abs().max()) <= 1e-3 * float(weight_grad.abs().max())


def _grads_close(tmodel, jgrads, tcfg, atol):
    """Every parameter's gradient against JAX's (a parameter the loss does
    not reach has none here, zeros in JAX); the `_DEAD` biases' gradients
    are noise on both sides, next to their weights' gradients."""
    want = predictive_params_from_jax(jgrads, tcfg)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tmodel.named_parameters()}
    for n in got:
        if n in _DEAD:
            w = n.replace("bias", "weight")
            assert _noise(got[n], got[w]) and _noise(want[n], want[w]), n
        else:
            _close(got[n], want[n], atol, n)


@pytest.mark.parametrize("name", list(jl.LOSS2FN))
def test_each_loss_and_its_gradients_match_jax(name):
    """Each of the seven losses alone against `jax.value_and_grad`:
    per-sample values within 1e-3 of max(1, their largest magnitude) (the
    latent losses run to ~100), and the gradients of their mean for every
    parameter within 1e-3."""
    model, variables, tmodel = _pair()
    pix = _pixels(5)
    key = jax.random.PRNGKey(6)
    (jloss, (jlosses, _, _)), jgrads = _jax_loss(model, variables, jnp.asarray(pix), key,
                                                 None, name)
    tmodel.zero_grad()
    out = tmodel(torch.from_numpy(pix), rng=JaxRng(key), output_inputs=True)
    err, _ = tl.LOSS2FN[name](tmodel, torch.from_numpy(pix), out)
    err.mean().backward()
    _close(err, jlosses[name], 1e-3 * max(1.0, float(np.abs(jlosses[name]).max())))
    _grads_close(tmodel, jgrads["params"], tmodel.config, 1e-3)
    tmodel.zero_grad()


@pytest.mark.parametrize("normalize", [False, True])
def test_training_loss_gradients_and_mean_bar_match_jax(normalize):
    """`training_loss` over all seven (with and without
    `normalize_latent`): the mean error and every loss within 1e-3 of
    max(1, their magnitude), the gradients within 1e-3, and
    `patch_mean_bar` from its meta within 1e-4."""
    model, variables, tmodel = _pair()
    pix = _pixels(7)
    key = jax.random.PRNGKey(8)
    jtc = jp.PredictiveViTTrainingConfig(normalize_latent=normalize, **_ALL7)
    ttc = tp.PredictiveViTTrainingConfig(normalize_latent=normalize, **_ALL7)
    (jloss, (jlosses, jmeta, jout)), jgrads = _jax_loss(
        model, variables, jnp.asarray(pix), key, jtc)
    tmodel.zero_grad()
    out = tmodel(torch.from_numpy(pix), rng=JaxRng(key), output_inputs=True)
    err, losses, meta = tl.training_loss(tmodel, torch.from_numpy(pix), out, ttc)
    err.mean().backward()
    assert set(losses) == set(jlosses) == set(jl.LOSS2FN)
    _close(err.mean(), jloss, 1e-3 * max(1.0, abs(float(jloss))))
    for k in losses:
        _close(losses[k], jlosses[k], 1e-3 * max(1.0, float(np.abs(jlosses[k]).max())), k)
    _grads_close(tmodel, jgrads["params"], tmodel.config, 1e-3)
    tmodel.zero_grad()
    jbars = jl.patch_mean_bar(jout, jmeta, model.config)
    tbars = tl.patch_mean_bar(out, meta, tmodel.config)
    assert set(tbars) == set(jbars) == {"query_patch_mean_bar", "context_patch_mean_bar"}
    for k in jbars:
        _close(tbars[k], jbars[k], 1e-4, k)


def test_two_adamw_steps_match_optax():
    """Two steps of the sandbox losses under `make_optimizer(2e-3,
    weight_decay=1e-4)` against `optax.adamw(2e-3)`: the losses within 1e-3;
    after each step every parameter tensor within 1e-4 on >= 99.9% of its
    elements and, in L2, within 1e-2 of JAX's total update.  Adam's
    m / sqrt(v) maps a gradient at the level of f32 noise to +-lr,
    whichever side the noise fell: a handful of elements of the ~10M, and
    the two biases whose gradient is zero but for that noise (each is
    added to every token just before a standardisation over (batch,
    tokens): the encoder's `enc_dense` and the last trunk layer's `fc2`).
    Those two are held to the bound of two steps, 2 lr per element."""
    model, variables, _ = _pair()
    kw = {**GEOM, **SANDBOX}
    tcfg = tp.PredictiveViTConfig(policy=t_parity(), **kw)
    tmodel = tp.PredictiveViTModel(tcfg)
    tmodel.load_state_dict(predictive_params_from_jax(variables, tcfg), strict=True)
    jtc = jp.PredictiveViTTrainingConfig(context_patch_prediction=1e-4,
                                         query_patch_prediction=1.0,
                                         positional_regularization=0.5)
    ttc = ex.training_config("sandbox")
    start = predictive_params_from_jax(variables, tcfg)
    opt = optax.adamw(2e-3)
    jstate = opt.init(variables)

    @jax.jit
    def jstep(g, s, v):
        updates, s = opt.update(g, s, v)
        return optax.apply_updates(v, updates), s

    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]

    def loss_fn(m, pix, generator):
        out = m(pix, rng=JaxRng(keys[generator.initial_seed()]), output_inputs=True)
        return tl.training_loss(m, pix, out, ttc)[0].mean(), None

    optimizer = make_optimizer(2e-3, weight_decay=1e-4)
    step, state = train_step_fn(loss_fn, optimizer), optimizer.init(tmodel)
    for i in range(2):
        pix = _pixels(30 + i)
        (jloss, _), jgrads = _jax_loss(model, variables, jnp.asarray(pix), keys[i], jtc)
        jg = predictive_params_from_jax(jgrads, tcfg)
        for n in _DEAD:
            assert _noise(jg[n], jg[n.replace("bias", "weight")]), n
        variables, jstate = jstep(jgrads, jstate, variables)
        tloss, _ = step(tmodel, state, torch.from_numpy(pix), torch.Generator().manual_seed(i))
        _close(tloss, jloss, 1e-3)
        want = predictive_params_from_jax(variables, tcfg)
        for n, p in tmodel.named_parameters():
            diff = (p.detach() - want[n]).abs()
            if n in _DEAD:
                assert float(diff.max()) <= 2 * 2e-3 * (i + 1), n
                continue
            assert float((diff <= 1e-4).float().mean()) >= 0.999, n
            moved = float((want[n] - start[n]).norm())
            assert float(diff.norm()) <= 1e-2 * max(moved, 1e-12), n


# ---------------------------------------------------------- the rulings ----


def test_int_loss_weights_are_applied():
    """Ruling on the JAX package's `isinstance(weight, float)`: JAX drops
    ``query_patch_prediction=1`` (an int) without a word; the port weighs
    any real number, so an int weight equals its float."""
    model, variables, tmodel = _pair()
    pix = _pixels(9)
    key = jax.random.PRNGKey(10)
    jout = model.apply(variables, jnp.asarray(pix), rng=key)
    jerr, jlosses, _ = jl.training_loss(model, variables, jnp.asarray(pix), jout,
                                        jp.PredictiveViTTrainingConfig(query_patch_prediction=1))
    assert jlosses == {} and float(jnp.abs(jerr).max()) == 0.0  # dropped
    with torch.no_grad():
        out = tmodel(torch.from_numpy(pix), rng=JaxRng(key))
        e_int, l_int, _ = tl.training_loss(tmodel, torch.from_numpy(pix), out,
                                           tp.PredictiveViTTrainingConfig(query_patch_prediction=1))
        e_flt, _, _ = tl.training_loss(tmodel, torch.from_numpy(pix), out,
                                       tp.PredictiveViTTrainingConfig(query_patch_prediction=1.0))
    assert set(l_int) == {"query_patch_prediction"} and float(e_int.abs().min()) > 0
    torch.testing.assert_close(e_int, e_flt, rtol=0, atol=0)


def test_normalize_latent_without_inputs_raises():
    """Ruling on `normalize_latent` without `output_inputs=True`: JAX fails
    on None; the port raises a `ValueError` that names `output_inputs`."""
    model, variables, tmodel = _pair()
    pix = _pixels(11)
    key = jax.random.PRNGKey(12)
    jout = model.apply(variables, jnp.asarray(pix), rng=key)
    with pytest.raises((TypeError, AttributeError)):
        jl.training_loss(model, variables, jnp.asarray(pix), jout,
                         jp.PredictiveViTTrainingConfig(normalize_latent=True, **_ALL7))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(pix), rng=JaxRng(key))
        with pytest.raises(ValueError, match="output_inputs"):
            tl.training_loss(tmodel, torch.from_numpy(pix), out,
                             tp.PredictiveViTTrainingConfig(normalize_latent=True, **_ALL7))


def test_patch_mean_bar_mirrors_the_valid_count_normaliser():
    """Ruling on `patch_mean_bar`: mirrored.  Its context bar divides by
    the valid context tokens (sum of the lengths), where the context patch
    loss divides by `expected_context_length` per image; the port's bar
    equals JAX's (1e-4) and, for a constant predictor, differs from the
    loss's normalisation by sum(lengths) / (B * expected)."""
    _, _, tmodel = _pair()
    cfg = tmodel.config
    rng = np.random.default_rng(13)
    tc = rng.standard_normal((3, 3, 16, 16, 3)).astype(np.float32)
    lengths = np.array([1, 3, 2], np.int32)
    jbar = jl.patch_mean_bar({"context_lengths": jnp.asarray(lengths)},
                             {"true_context_patch": jnp.asarray(tc)}, cfg)
    tbar = tl.patch_mean_bar({"context_lengths": torch.from_numpy(lengths).long()},
                             {"true_context_patch": torch.from_numpy(tc)}, cfg)
    _close(tbar["context_patch_mean_bar"], jbar["context_patch_mean_bar"], 1e-4)
    valid = np.arange(3)[None] < lengths[:, None]
    mean = tc[valid].mean(0)
    sq = ((tc - mean) ** 2).reshape(3, 3, -1).sum(-1) * valid
    as_loss = (sq.sum(1) / (cfg.expected_context_length * 16**2)).mean()
    bar = sq.sum() / valid.sum() / 16**2
    _close(tbar["context_patch_mean_bar"], bar, 1e-4)
    np.testing.assert_allclose(bar / as_loss,
                               3 * cfg.expected_context_length / lengths.sum(), rtol=1e-5)


# -------------------------------------------------------------- example ----


def test_example_cli_on_the_cpu(tmp_path):
    """The example on `--device cpu` for 2 steps at a tiny config: it
    writes metrics.jsonl and summary.json, every logged loss finite, and the
    figures of `--viz-at`'s default steps (0, mid = end = 1); without a card
    `--device cuda` raises."""
    cfg = ex.sandbox_config(**GEOM)
    args = ["--device", "cpu", "--steps", "2", "--batch", "2", "--corpus-size", "4",
            "--log-every", "1", "--out", str(tmp_path)]
    summary = ex.main(args + ["--losses", "all7"], config=cfg)
    run = tmp_path / "predictive_all7"
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1] and len(summary["history"]) == 2
    assert set(rows[0]) >= {"total", *jl.LOSS2FN}
    assert all(np.isfinite(v) for r in summary["history"] for v in r.values())
    assert json.load(open(run / "summary.json"))["steps"] == 2
    assert sorted(p.name for p in run.glob("sample_step*.png")) == [
        "sample_step0.png", "sample_step1.png"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.main(["--steps", "1", "--out", os.fspath(tmp_path)], config=cfg)
