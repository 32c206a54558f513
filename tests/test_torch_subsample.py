"""PyTorch port, the subsample family against the JAX package (CPU), at a
tiny config (2 layers, width 64, 4 heads, 32 px, patch 8, grid 2 -> x2,
depth 2: 84 slots): the quadtree tables, the embeddings, the model in its
three modes with and without weighted tokens (outputs, split masks and
every log), the classifier's three problem types, `reinforce_loss` and the
gradients of the REINFORCE objective, `transfer_base_to_subsample`, the
example's CLI, and the key-only mask's row stride.  Weights go through
`subsample_classifier_params_from_jax`; the policy draws JAX's numbers
through `JaxRng`.  f32 at the 1e-3 bar unless a test says otherwise; one
jitted JAX function per config, cached."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.compat.family_import import transfer_base_to_subsample as j_transfer
from msvit_tpu.models import subsample as js
from msvit_tpu.models.base import BaseViTConfig as JBaseConfig
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import (
    subsample_classifier_params_from_jax, subsample_params_from_jax,
    transfer_base_to_subsample, vit_params_from_jax)
from msvit_tpu_torch.examples import train_subsample_synthetic as ex
from msvit_tpu_torch.models import subsample as ts
from msvit_tpu_torch.ops.fused_attention import _mask_args
from msvit_tpu_torch.settings import parity_policy as t_parity
from test_torch_clustering import JaxRng

GEOM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
            patch_size=8, initial_grid_size=2, multiplicative_grid_size=2, max_depth=2,
            num_labels=5)
B = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


def _pixels(seed):
    return np.random.default_rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels(problem, seed):
    rng = np.random.default_rng(seed)
    if problem == "single_label_classification":
        return rng.integers(0, 5, B).astype(np.int32)
    if problem == "multi_label_classification":
        return (rng.random((B, 5)) < 0.4).astype(np.float32)
    return rng.standard_normal((B, 5)).astype(np.float32)


def random_tree(shapes, seed, special=None):
    """Values for the tree of `jax.eval_shape(init)` (a trace, no compile),
    drawn from a numpy seed as flax's initializers draw them: LayerNorm
    scales and LayerScale 1, the rest N(0, 0.02^2) (biases too, so that they
    are exercised); `special` maps a leaf name to its own (mean, std)."""
    rng = np.random.default_rng(seed)
    special = special or {}

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        mean, std = special.get(name.rstrip("0123456789_"), (0.0, 0.02))
        if name in ("scale", "layer_scale1", "layer_scale2"):
            mean, std = 1.0, 0.0
        return (mean + std * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _variables():
    """JAX params of the tiny classifier: the param tree is the same in
    every mode, problem type and policy."""
    model = js.SubsampleViTForImageClassification(js.SubsampleViTConfig(**GEOM))
    key = jax.random.PRNGKey(7)
    shapes = jax.eval_shape(model.init, {"params": key, "policy": key},
                            jnp.asarray(_pixels(0)),
                            jnp.asarray(_labels("single_label_classification", 0)))
    return random_tree(shapes, 7)


@functools.lru_cache(maxsize=None)
def _jax(mode="open", weighted=False, problem="single_label_classification", f32=True):
    """(config kwargs, JAX classifier, its variables, a jitted apply with
    logs) for one config."""
    kw = dict(GEOM, nesting_mode=mode, use_weighted_tokens=weighted, problem_type=problem)
    jcfg = js.SubsampleViTConfig(**kw, **({"policy": j_parity()} if f32 else {}))
    model = js.SubsampleViTForImageClassification(jcfg)
    fwd = jax.jit(lambda v, x, y, k: model.apply(v, x, y, rng=k, output_logs=True,
                                                 return_pixel_values=True))
    return (kw, f32), model, _variables(), fwd


def _port(kw, variables):
    kw, f32 = kw
    cfg = ts.SubsampleViTConfig(**kw, **({"policy": t_parity()} if f32 else {}))
    model = ts.SubsampleViTForImageClassification(cfg)
    model.load_state_dict(subsample_classifier_params_from_jax(variables, cfg), strict=True)
    return model.eval()


# ------------------------------------------------------------- the tree ----


@pytest.mark.parametrize("geom", [dict(initial_grid_size=2, multiplicative_grid_size=2,
                                       max_depth=2),
                                  dict(initial_grid_size=4, multiplicative_grid_size=2,
                                       max_depth=3),
                                  dict(initial_grid_size=3, multiplicative_grid_size=3,
                                       max_depth=1)])
def test_quadtree_tables_bit_equal(geom):
    """`build_quadtree`'s tables (corners, depth, parent, child_start,
    level offsets) and the capacity equal JAX's bit for bit; the 448-px
    depth-3 tree has 1,360 slots."""
    jt = js.build_quadtree(js.SubsampleViTConfig(**geom))
    tcfg = ts.SubsampleViTConfig(**geom)
    tt = ts.build_quadtree(tcfg)
    for f in ("corners", "depth", "parent", "child_start"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tt.level_offsets == jt.level_offsets
    assert tcfg.capacity == js.SubsampleViTConfig(**geom).capacity == tt.corners.shape[0]
    if geom["max_depth"] == 3:
        assert tcfg.capacity == 1360
    box = np.array([[[-1.0, -0.5], [0.25, 1.0]]], np.float32)
    assert np.array_equal(ts.subdivide_boxes(box, 3), js.subdivide_boxes(box, 3))


def test_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(js.SubsampleViTConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ts.SubsampleViTConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if n == "policy":
            assert dataclasses.asdict(jd) == dataclasses.asdict(td)
        else:
            assert jd == td, n


# ----------------------------------------------------------- embeddings ----


def test_embeddings_match_jax():
    """Every slot's P x P bicubic lattice (zeros padding) and its embedding
    (projection plus the position table sampled at the box center)."""
    kw, _, variables, _ = _jax()
    model = _port(kw, variables)
    jcfg = js.SubsampleViTConfig(**kw[0], policy=j_parity())
    corners = js.build_quadtree(jcfg).corners
    pix = _pixels(1)
    jemb = jax.jit(functools.partial(js.SubsampleViTEmbeddings(jcfg).apply,
                                     return_pixel_values=True))(
        {"params": variables["params"]["model"]["embeddings"]}, jnp.asarray(pix),
        jnp.asarray(corners))
    with torch.no_grad():
        temb = model.model.embeddings(torch.from_numpy(pix), torch.from_numpy(corners),
                                      return_pixel_values=True)
    assert temb[0].shape == jemb[0].shape == (B, 84, 64)
    assert temb[1].shape == jemb[1].shape == (B, 84, 8, 8, 3)
    _close(temb[1], jemb[1], 1e-5, "patches")
    _close(temb[0], jemb[0], 1e-4, "embeddings")


# ---------------------------------------------------------------- model ----


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["open", "lock", "freeze"])
def test_model_matches_jax(mode, weighted):
    """Two forwards (two policy keys) per mode: the split masks, the valid
    mask and every bool log equal; last_hidden_state, log_prob, the
    subsample logits, the classifier's logits and per-sample loss within
    1e-3; corners and depths equal."""
    kw, _, variables, fwd = _jax(mode, weighted)
    model = _port(kw, variables)
    pix, labels = _pixels(2), _labels("single_label_classification", 2)
    splits = 0
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        jout = fwd(variables, jnp.asarray(pix), jnp.asarray(labels), key)
        with torch.no_grad():
            tout = model(torch.from_numpy(pix), torch.from_numpy(labels), rng=JaxRng(key),
                         output_logs=True, return_pixel_values=True)
        assert np.array_equal(tout["last_valid_mask"].numpy(), np.asarray(jout["last_valid_mask"]))
        for name in ("valid_masks", "subsample_masks", "depths"):
            for a, b in zip(tout["logs"][name], jout["logs"][name]):
                assert np.array_equal(a.numpy(), np.asarray(b)), name
        for a, b in zip(tout["logs"]["corners"], jout["logs"]["corners"]):
            assert np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tout["logs"]["subsample_logits"], jout["logs"]["subsample_logits"]):
            _close(a, b, 1e-3, "subsample_logits")
        assert len(tout["logs"]["valid_masks"]) == 3
        _close(tout["last_hidden_state"], jout["last_hidden_state"], 1e-3, "last_hidden_state")
        _close(tout["log_prob"], jout["log_prob"], 1e-3, "log_prob")
        _close(tout["classifier_logits"], jout["classifier_logits"], 1e-3, "logits")
        _close(tout["loss"], jout["loss"], 1e-3, "loss")
        _close(tout["pixel_values"], jout["pixel_values"], 1e-5, "pixel_values")
        splits += int(sum(m.sum() for m in tout["logs"]["subsample_masks"][:2]))
    assert splits > 0  # the tree grew below the roots


def test_freeze_mode_sends_a_key_only_mask(monkeypatch):
    """Freeze mode's trunk calls: queries are level `it`'s slots, the
    context the shallower levels' cached states (one per layer), and the
    mask a key-only [B, 1, 1, 1 + (hi - lo) + lo] whose CLS column is 0.
    So no query row is ever fully masked here: CLS, always attended, keeps
    every row's softmax over at least one real key."""
    kw, _, variables, _ = _jax("freeze")
    model = _port(kw, variables)
    seen = []
    encoder = model.model.encoder
    real = encoder.forward

    def spy(hidden, context_states=None, attention_mask=None, **kwargs):
        seen.append((hidden.shape[1], None if context_states is None else
                     [c.shape[1] for c in context_states], attention_mask))
        return real(hidden, context_states=context_states, attention_mask=attention_mask,
                    **kwargs)

    monkeypatch.setattr(encoder, "forward", spy)
    with torch.no_grad():
        model(torch.from_numpy(_pixels(5)), rng=JaxRng(jax.random.PRNGKey(5)))
    offsets = model.model.tree.level_offsets
    assert len(seen) == 3
    for it, (nq, ctx, mask) in enumerate(seen):
        lo, hi = offsets[it], offsets[it + 1]
        assert nq == 1 + hi - lo
        assert ctx == (None if lo == 0 else [lo] * 2)
        assert mask.shape == (B, 1, 1, 1 + hi - lo + lo)
        assert torch.equal(mask[..., 0], torch.zeros(B, 1, 1))


def test_bf16_policy_matches_jax():
    """The default policy (bf16 compute, cached states held in bf16 and
    read in f32 by the policy, as in JAX): at policy key 11 the split
    masks and the valid mask equal JAX's, and last_hidden_state agrees by
    cosine >= 0.999 per image (bf16 products on two backends differ in
    their roundings, so the f32 bar does not apply)."""
    kw, _, variables, fwd = _jax(f32=False)
    model = _port(kw, variables)
    pix, labels = _pixels(6), _labels("single_label_classification", 6)
    key = jax.random.PRNGKey(11)
    jout = fwd(variables, jnp.asarray(pix), jnp.asarray(labels), key)
    with torch.no_grad():
        tout = model(torch.from_numpy(pix), torch.from_numpy(labels), rng=JaxRng(key),
                     output_logs=True)
    for a, b in zip(tout["logs"]["subsample_masks"], jout["logs"]["subsample_masks"]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tout["last_valid_mask"].numpy(), np.asarray(jout["last_valid_mask"]))
    a, b = _np(tout["last_hidden_state"]).reshape(B, -1), _np(jout["last_hidden_state"]).reshape(B, -1)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() >= 0.999
    _close(tout["log_prob"], jout["log_prob"], 2e-2, "log_prob")


@pytest.mark.parametrize("problem", ["regression", "multi_label_classification"])
def test_classifier_problem_types_match_jax(problem):
    """The regression and multi-label losses (single-label runs in
    `test_model_matches_jax`), with weighted tokens: logits and per-sample
    loss within 1e-3."""
    kw, _, variables, fwd = _jax("open", True, problem)
    model = _port(kw, variables)
    pix, labels = _pixels(7), _labels(problem, 7)
    key = jax.random.PRNGKey(8)
    jout = fwd(variables, jnp.asarray(pix), jnp.asarray(labels), key)
    with torch.no_grad():
        tout = model(torch.from_numpy(pix), torch.from_numpy(labels), rng=JaxRng(key))
    _close(tout["classifier_logits"], jout["classifier_logits"], 1e-3)
    _close(tout["loss"], jout["loss"], 1e-3)
    assert tout["loss"].shape == (B,)


def test_reinforce_loss_matches_jax():
    """Population variance, the reward detached: the value within 1e-6 and
    the gradient reaches log_prob only."""
    rng = np.random.default_rng(9)
    loss, logp = rng.random(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    jval, jg = jax.value_and_grad(js.reinforce_loss, argnums=(0, 1))(jnp.asarray(loss),
                                                                     jnp.asarray(logp))
    tl, tp = (torch.from_numpy(x).requires_grad_() for x in (loss, logp))
    val = ts.reinforce_loss(tl, tp)
    val.backward()
    _close(val, jval, 1e-6)
    _close(tp.grad, jg[1], 1e-6)
    assert tl.grad is None and float(np.abs(jg[0]).max()) == 0.0


def test_gradients_match_jax():
    """The gradients of reinforce_loss + mean(loss) for every parameter
    against `jax.grad` (the same policy key: the same splits), within 1e-3
    of max(1, the largest magnitude), in freeze mode with weighted tokens
    (the context path and the depth bias on the way)."""
    kw, model_j, variables, _ = _jax("freeze", True)
    model = _port(kw, variables).train()
    pix, labels = _pixels(10), _labels("single_label_classification", 10)
    key = jax.random.PRNGKey(12)

    def jloss(params):
        out = model_j.apply({"params": params}, jnp.asarray(pix), jnp.asarray(labels), rng=key)
        return js.reinforce_loss(out["loss"], out["log_prob"]) + jnp.mean(out["loss"])

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    out = model(torch.from_numpy(pix), torch.from_numpy(labels), rng=JaxRng(key))
    val = ts.reinforce_loss(out["loss"], out["log_prob"]) + out["loss"].mean()
    val.backward()
    _close(val, jval, 1e-4)
    want = subsample_classifier_params_from_jax(jgrads)
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want[n], 1e-3 * max(1.0, float(want[n].abs().max())), n)


# ------------------------------------------------------------- transfer ----


def test_transfer_base_to_subsample_matches_jax():
    """A 3-layer ViT at 48 px (a 6 x 6 table) into the 2-layer, 32-px
    subsample model (4 x 4): layers by index, projection, the resampled
    table with its CLS row and the CLS token equal JAX's transfer (1e-5;
    the resampling in f32), for the model's and the classifier's state
    dicts; the rest untouched.  A base trunk too shallow raises, naming the
    missing layers, in both packages."""
    kw, _, variables, _ = _jax()
    bcfg = JBaseConfig(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                       image_size=48, patch_size=8, policy=j_parity())
    base = random_tree(jax.eval_shape(JViT(bcfg).init, jax.random.PRNGKey(13),
                                      jnp.zeros((1, 48, 48, 3))), 13)["params"]
    params = variables["params"]
    want = subsample_classifier_params_from_jax(j_transfer(base, params, 2))
    model = _port(kw, variables)
    base_state = vit_params_from_jax(base)
    got = transfer_base_to_subsample(base_state, model.state_dict(), 2)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)
    before = model.state_dict()
    assert torch.equal(got["model.projection.weight"], before["model.projection.weight"])
    assert torch.equal(got["model.encoder.layer.1.mlp.fc1.weight"],
                       base_state["encoder.layer.1.mlp.fc1.weight"])
    got_m = transfer_base_to_subsample(base_state, model.model.state_dict(), 2)
    want_m = subsample_params_from_jax(j_transfer(base, params["model"], 2))
    for k in want_m:
        _close(got_m[k], want_m[k], 1e-5, k)
    with pytest.raises(ValueError, match=r"no layer\(s\) \[3\]"):
        j_transfer(base, params, 4)
    with pytest.raises(ValueError, match=r"no layer\(s\) \[3\]"):
        transfer_base_to_subsample(base_state, model.state_dict(), 4)


# ---------------------------------------------------------- key-only mask --


def test_mask_args_row_stride():
    """`_mask_args` takes a key-only mask [B|1, 1|H, 1, Nk] with row stride
    0 (never expanded: the tensor handed to the kernel is the mask
    itself), keeps a full mask's row stride, and refuses other shapes."""
    dev = torch.device("cpu")
    key_only = torch.zeros(2, 1, 1, 1361)
    kind, m, sb, sh, sr = _mask_args(key_only, 2, 12, 1025, 1361, dev, "t")
    assert (kind, sb, sh, sr) == (2, 1361, 0, 0) and m.data_ptr() == key_only.data_ptr()
    kind, m, sb, sh, sr = _mask_args(torch.ones(1, 1, 1, 9, dtype=torch.bool), 2, 3, 5, 9,
                                     dev, "t")
    assert (kind, sb, sh, sr) == (1, 0, 0, 0) and m.dtype == torch.uint8
    full = torch.zeros(2, 3, 5, 9)
    assert _mask_args(full, 2, 3, 5, 9, dev, "t")[2:] == (135, 45, 9)
    view = torch.zeros(2, 1, 5, 16)[..., :9]  # rows 16 apart
    assert _mask_args(view, 2, 3, 5, 9, dev, "t")[2:] == (80, 0, 16)
    for bad in (torch.zeros(2, 1, 2, 9), torch.zeros(2, 1, 5, 8), torch.zeros(3, 1, 1, 9)):
        with pytest.raises(ValueError, match="does not fit"):
            _mask_args(bad, 2, 3, 5, 9, dev, "t")


# -------------------------------------------------------------- example ----


def test_example_cli_on_the_cpu(tmp_path):
    """The example on `--device cpu`, 2 warmup and 2 REINFORCE steps at the
    tiny config: finite logged losses, precision and recall in [0, 1], the
    three controls' accuracies, the never-subdivide control at the root
    count and the always one at the capacity's leaves, the quadtree
    figure; without a card `--device cuda` raises."""
    cfg = ts.SubsampleViTConfig(**{**GEOM, "num_labels": 10})
    args = ["--device", "cpu", "--warmup", "2", "--steps", "2", "--batch", "4",
            "--corpus-size", "8", "--eval-size", "8", "--log-every", "1",
            "--out", str(tmp_path)]
    summary = ex.main(args, config=cfg)
    rows = summary["history"]
    assert [r["phase"] for r in rows] == ["warmup"] * 2 + ["reinforce"] * 2
    assert all(np.isfinite(r["ce"]) for r in rows)
    for r in rows[2:]:
        assert 0.0 <= r["precision"] <= 1.0 and 0.0 <= r["recall"] <= 1.0
    assert summary["tokens_never"] == cfg.num_roots
    assert summary["tokens_always"] == cfg.num_roots * cfg.children_per_split**cfg.max_depth
    for k in ("acc_learned", "acc_never", "acc_always"):
        assert 0.0 <= summary[k] <= 1.0
    saved = json.load(open(tmp_path / "subsample" / "summary.json"))
    assert saved["steps"] == 2 and os.path.exists(tmp_path / "subsample" / "metrics.jsonl")
    assert (tmp_path / "subsample" / "quadtree.png").stat().st_size > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.main(["--steps", "1", "--out", str(tmp_path)], config=cfg)
