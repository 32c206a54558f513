"""PyTorch port, the dense pretrain slice against the JAX package on the
CPU: the synthetic corpus (bit-equal), the gradient clip against optax's
chain, the host-to-device feed, the base-to-multistate transfer, the
example's loss through `Trainer` against JAX's, and the example's CLI."""

import dataclasses
import itertools
import json
import threading
import time

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from msvit_tpu.compat.family_import import transfer_base_to_multistate as j_transfer
from msvit_tpu.data import augment as jaug
from msvit_tpu.data import synthetic as jsyn
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base.vit import ViTForImageClassification as JCls
from msvit_tpu.models.clustering import SpectralClusteringConfig as JSpectral
from msvit_tpu.models.multistate import MultiStateViTConfig as JMsCfg
from msvit_tpu.models.multistate import MultiStateViTEncoderModel as JMs
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu.train.trainer import Trainer as JTrainer
from msvit_tpu_torch.compat import (
    classifier_params_from_jax, multistate_params_from_jax, vit_params_from_jax)
from msvit_tpu_torch.compat.family import transfer_base_to_multistate
from msvit_tpu_torch.data import augment as taug
from msvit_tpu_torch.data import pipeline as tpipe
from msvit_tpu_torch.data import synthetic as tsyn
from msvit_tpu_torch.examples import pretrain_synthetic as ps
from msvit_tpu_torch.examples import train_multistate as tms
from msvit_tpu_torch.models.base import ViTForImageClassification as TCls
from msvit_tpu_torch.train import (
    Trainer, apply_if_finite, make_optimizer, restore_checkpoint, train_step_fn)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------- corpus ----


@pytest.mark.parametrize("label_mode", ["largest", "center", "texture", "ltexture"])
def test_generate_batch_bit_equal(label_mode):
    """Pixels, regions and labels equal the JAX package's, seed for seed."""
    seeds = [0, 1, 7, 1_000_003, 10_000_000]
    got = tsyn.generate_batch(seeds, size=64, label_mode=label_mode)
    want = jsyn.generate_batch(seeds, size=64, label_mode=label_mode)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tsyn.label_classes(label_mode) == jsyn.label_classes(label_mode)


def test_generate_scene_params_and_single_object():
    for seed in (3, 4):
        a = tsyn.generate_scene(seed, size=48, max_objects=1, label_mode="center")
        b = jsyn.generate_scene(seed, size=48, max_objects=1, label_mode="center")
        assert a["params"] == b["params"] and a["label"] == b["label"]
        np.testing.assert_array_equal(a["image"], b["image"])
    with pytest.raises(ValueError, match="label_mode"):
        tsyn.generate_scene(0, label_mode="nope")


@pytest.mark.parametrize("uint8", [True, False])
def test_corpus_batches_order_equal(uint8):
    """The same shuffled stream over two epochs, regions included."""
    data = tsyn.generate_batch(range(10), size=32)
    a = tsyn.corpus_batches(data, 4, seed=5, include_regions=True, uint8=uint8)
    b = jsyn.corpus_batches(data, 4, seed=5, include_regions=True, uint8=uint8)
    for x, y in itertools.islice(zip(a, b), 5):  # 2 batches an epoch
        assert set(x) == set(y)
        for k in y:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_jpeg_corpus_round_trip(tmp_path):
    """`ensure_corpus` writes JPEGs once and loads them through the port's
    PIL decode: labels and regions exact, pixels within JPEG's loss of the
    generated ones (mean abs < 10 of 255: quality 92 with subsampled chroma
    on 64-px gratings and checkers; 6.0 measured) and near the JAX package's
    load of the same files."""
    pytest.importorskip("PIL")
    data = tsyn.ensure_corpus(str(tmp_path), 6, size=64, seed=2, label_mode="texture")
    want = tsyn.generate_batch([2 * 1_000_003 + i for i in range(6)], size=64,
                               label_mode="texture")
    np.testing.assert_array_equal(data["labels"], want["labels"])
    np.testing.assert_array_equal(data["regions"], want["regions"])
    assert data["images"].dtype == np.uint8 and data["num_classes"] == 4
    diff = np.abs(data["images"].astype(np.float32) - want["images"].astype(np.float32))
    assert diff.mean() < 10.0
    mtime = (tmp_path / "corpus64_texture" / "manifest.json").stat().st_mtime_ns
    again = tsyn.ensure_corpus(str(tmp_path), 6, size=64, seed=2, label_mode="texture")
    assert (tmp_path / "corpus64_texture" / "manifest.json").stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(again["images"], data["images"])
    # the JAX package reads the same directory (its own decoder may scale
    # in the DCT domain: mean abs < 1)
    theirs = jsyn.load_corpus(str(tmp_path / "corpus64_texture"))
    assert np.abs(theirs["images"].astype(np.float32)
                  - data["images"].astype(np.float32)).mean() < 1.0


def test_pipeline_host_and_device_paths():
    """`preprocess_images` and `preprocess_on_device` against the JAX
    package's (numpy path: 1e-6; device path at the native size and 2x up:
    1e-4), grayscale and alpha inputs through `to_rgb_array`."""
    from msvit_tpu.data import pipeline as jpipe

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
            rng.integers(0, 256, (16, 16), dtype=np.uint8),
            rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)]
    cfg_t, cfg_j = tpipe.ImagePipelineConfig(image_size=32), jpipe.ImagePipelineConfig(image_size=32)
    want = np.stack([
        (jpipe._resize_bilinear_np(jpipe.to_rgb_array(im).astype(np.float32), 32, 32) / 255.0
         - 0.5) / 0.5 for im in imgs])
    np.testing.assert_allclose(tpipe.preprocess_images(imgs, cfg_t), want, atol=1e-6)
    u8 = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    for size in (16, 32):
        got = tpipe.preprocess_on_device(torch.from_numpy(u8),
                                         tpipe.ImagePipelineConfig(image_size=size))
        ref = jpipe.preprocess_on_device(jnp.asarray(u8),
                                         jpipe.ImagePipelineConfig(image_size=size))
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4)


# ----------------------------------------------------------------- clip ----


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([0.5, 0.1, -0.2]))
        self.b = nn.Parameter(torch.tensor(0.3))


def _toy_loss_t(model, batch, gen):
    x, gain = batch
    loss = gain * ((x @ model.w + model.b - 1.0) ** 2).mean()
    return loss, {}


def _toy_grads_j(params, x, gain):
    return jax.grad(lambda p: gain * jnp.mean((x @ p["w"] + p["b"] - 1.0) ** 2))(params)


def test_clip_matches_optax_chain():
    """`make_optimizer(clip_norm=c)` against `optax.chain(
    optax.clip_by_global_norm(c), optax.adamw(...))` for three steps: the
    first clipped (norm > c), the second not, the third clipped again;
    params <= 1e-5.  `grad_norm` reports the unclipped norm."""
    clip, sched = 0.5, (lambda s: 0.05 * (s + 1) / 3)
    jopt = optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(sched, weight_decay=0.1))
    jp = {"w": jnp.asarray([0.5, 0.1, -0.2]), "b": jnp.asarray(0.3)}
    js = jopt.init(jp)
    model = _Toy()
    opt = make_optimizer(sched, weight_decay=0.1, clip_norm=clip)
    st = opt.init(model)
    step = train_step_fn(_toy_loss_t, opt, monitor=True)
    rng = np.random.default_rng(0)
    clipped = []
    for gain in (40.0, 0.01, 40.0):
        x = rng.standard_normal((16, 3)).astype(np.float32)
        g = _toy_grads_j(jp, jnp.asarray(x), gain)
        norm = float(optax.global_norm(g))
        clipped.append(norm > clip)
        updates, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, updates)
        _, aux = step(model, st, (torch.from_numpy(x), gain), torch.Generator())
        np.testing.assert_allclose(float(aux["grad_norm"]), norm, rtol=1e-5)
        # the gradients left on the parameters are the clipped ones
        left = float(torch.linalg.vector_norm(
            torch.stack([p.grad.norm() for p in model.parameters()])))
        np.testing.assert_allclose(left, min(norm, clip), rtol=1e-5)
        np.testing.assert_allclose(_np(model.w), _np(jp["w"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(model.b), _np(jp["b"]), atol=1e-5, rtol=0)
    assert clipped == [True, False, True]


def test_clip_off_and_finiteness_on_unclipped_gradients():
    """clip_norm None or 0 leaves the step alone; under apply_if_finite a
    NaN gradient skips the step (params and count of bad steps as optax's
    `apply_if_finite(chain(clip, adamw))`), and the next good step is
    taken from untouched moments."""
    assert make_optimizer(1e-2, clip_norm=0).clip_norm is None
    x = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    jopt = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(0.05, weight_decay=0.0)), 3)
    jp = {"w": jnp.asarray([0.5, 0.1, -0.2]), "b": jnp.asarray(0.3)}
    js = jopt.init(jp)
    model = _Toy()
    opt = apply_if_finite(make_optimizer(0.05, weight_decay=0.0, clip_norm=0.5), 3)
    st = opt.init(model)
    step = train_step_fn(_toy_loss_t, opt)
    for gain in (float("nan"), 40.0):
        g = _toy_grads_j(jp, jnp.asarray(x), gain)
        updates, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, updates)
        step(model, st, (torch.from_numpy(x), gain), torch.Generator())
        np.testing.assert_allclose(_np(model.w), _np(jp["w"]), atol=1e-5, rtol=0)
        assert torch.isfinite(model.w).all()
    assert int(st.total_notfinite) == int(js.total_notfinite) == 1


# ------------------------------------------------------------- prefetch ----


def _alive() -> int:
    return sum(t.name == "prefetch_to_device" and t.is_alive()
               for t in threading.enumerate())


def test_prefetch_keeps_order_and_converts():
    items = [{"pixel_values": np.full((2, 3), i, np.uint8), "labels": np.array([i, i]),
              "tag": f"b{i}"} for i in range(7)]
    out = list(tpipe.prefetch_to_device(iter(items), buffer_size=2, device="cpu"))
    assert [o["tag"] for o in out] == [f"b{i}" for i in range(7)]
    for i, o in enumerate(out):
        assert isinstance(o["pixel_values"], torch.Tensor)
        assert o["pixel_values"].dtype == torch.uint8 and int(o["labels"][0]) == i
    assert _alive() == 0


def test_prefetch_depth_is_bounded_and_transform_runs():
    """With a stalled consumer the worker runs at most buffer_size + 1
    batches ahead (the queue plus the one it holds)."""
    made = []

    def source():
        for i in itertools.count():
            made.append(i)
            yield {"x": np.array([i], np.float32)}

    it = tpipe.prefetch_to_device(source(), buffer_size=2, device="cpu",
                                  transform=lambda d: {"x": d["x"] * 2})
    first = next(it)
    assert float(first["x"]) == 0.0
    time.sleep(0.5)
    assert len(made) <= 1 + 2 + 1
    assert float(next(it)["x"]) == 2.0
    it.close()
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n and _alive() == 0


def test_prefetch_reraises_the_workers_exception():
    def source():
        yield {"x": np.zeros(1, np.float32)}
        raise KeyError("decode failed")

    it = tpipe.prefetch_to_device(source(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="decode failed"):
        next(it)
    assert _alive() == 0


def test_prefetch_defaults_to_the_card():
    """No device named: the card, and without one it raises (the CPU only
    by request)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tpipe.prefetch_to_device(iter([{"x": np.zeros(1)}])))
    with pytest.raises(ValueError, match="buffer_size"):
        next(tpipe.prefetch_to_device(iter([]), buffer_size=0, device="cpu"))


# ------------------------------------------------------------- transfer ----

GEOM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            image_size=48, patch_size=16)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_transfer_base_to_multistate_matches_jax(qk_norm):
    """The port's transfer on converted state dicts equals the conversion
    of JAX's transfer on the param trees, tensor for tensor: patch
    projection, position table without its CLS row, every layer (q/k norms
    too), TX and RX from the CLS token."""
    pix = jnp.zeros((1, 48, 48, 3))
    jcfg = JCfg(qk_norm=qk_norm, **GEOM)
    base = JCls(jcfg, num_labels=5).init({"params": jax.random.PRNGKey(0)}, pix)["params"]
    ms_cfg = JMsCfg(qk_norm=qk_norm, pregeneration_period=1, generation_period=1,
                    clustering=JSpectral(ncut_dim=4, num_sample=8, max_clusters=4), **GEOM)
    ms = JMs(ms_cfg).init({"params": jax.random.PRNGKey(1),
                           "clustering": jax.random.PRNGKey(1)}, pix)["params"]
    want = multistate_params_from_jax(j_transfer(base["vit"], ms, 2))
    got = transfer_base_to_multistate(
        vit_params_from_jax(base["vit"]), multistate_params_from_jax(ms), 2)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # what moved, and copies (not views of the source)
    before = multistate_params_from_jax(ms)
    assert not torch.equal(got["backbone.transmitter_token"],
                           before["backbone.transmitter_token"])
    assert torch.equal(got["backbone.receiver_token"], got["backbone.transmitter_token"])
    assert (got["backbone.receiver_token"].data_ptr()
            != got["backbone.transmitter_token"].data_ptr())


def test_transfer_refuses_mismatched_trunks():
    pix = jnp.zeros((1, 48, 48, 3))
    jbase = JCls(JCfg(qk_norm=True, **GEOM), num_labels=5).init(
        {"params": jax.random.PRNGKey(0)}, pix)["params"]["vit"]
    base = vit_params_from_jax(jbase)
    jms_tree = JMs(JMsCfg(
        pregeneration_period=1, generation_period=1,
        clustering=JSpectral(ncut_dim=4, num_sample=8, max_clusters=4), **GEOM)).init(
            {"params": jax.random.PRNGKey(1), "clustering": jax.random.PRNGKey(1)},
            pix)["params"]
    ms = multistate_params_from_jax(jms_tree)
    with pytest.raises(ValueError, match="qk_norm"):
        transfer_base_to_multistate(base, ms, 2)
    # a position table of another length (4 rows, a 2 x 2 grid, against
    # the base's 3 x 3) is resampled as JAX resamples it (1e-5, f32)
    short = dict(ms)
    short["embeddings.position_embeddings"] = ms["embeddings.position_embeddings"][:, :4]
    base_plain = {k: v for k, v in base.items() if "_norm." not in k or "attention" not in k}
    got = transfer_base_to_multistate(base_plain, short, 2)["embeddings.position_embeddings"]
    jms_short = {**jms_tree, "embeddings": {
        **jms_tree["embeddings"],
        "position_embeddings": jms_tree["embeddings"]["position_embeddings"][:, :4]}}
    want = j_transfer(jbase, jms_short, 2)["embeddings"]["position_embeddings"]
    assert got.shape == (1, 4, 64)
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)), rtol=0, atol=1e-5)


# -------------------------------------------------------------- example ----


def _args(tmp_path, *extra):
    return ps.build_parser().parse_args(
        ["--device", "cpu", "--preset", "small", "--batch", "4", "--eval-size", "8",
         "--out", str(tmp_path), *extra])


def test_warmup_cosine_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=3, decay_steps=20)
    got = ps.warmup_cosine(3e-4, 3, 20)
    for s in (0, 1, 2, 3, 4, 10, 19, 20, 25):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("peak, warmup, decay", [(3e-4, 3, 20), (1e-3, 50, 1000)])
def test_warmup_cosine_takes_the_device_count(peak, warmup, decay):
    """The schedule on an int32 0-d tensor (the optimizer's count of applied
    steps) against optax's, steps 0 to 10 past decay: a 0-d f32 tensor
    within 1e-7 relative.  Beside it an absolute peak * 2^-24, one f32 ulp
    of the cosine factor near 1: XLA's and torch's f32 cos differ in the
    last bit at a few steps (the port rounds an f64 cos)."""
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps=warmup,
                                              decay_steps=decay)
    got = ps.warmup_cosine(peak, warmup, decay)
    steps = np.arange(decay + 11)
    out = [got(torch.tensor(int(s), dtype=torch.int32)) for s in steps]
    assert all(o.dtype == torch.float32 and o.ndim == 0 for o in out)
    np.testing.assert_allclose(np.array([float(o) for o in out]),
                               np.asarray(want(steps)), rtol=1e-7,
                               atol=peak * 2.0**-24)


def test_trainer_steps_of_the_examples_loss_match_jax(tmp_path, monkeypatch):
    """Three `Trainer` steps of the example's loss at `--preset small` (f32,
    dropout off, the clip at 1.0, warmup-cosine AdamW, non-finite skip on)
    against the JAX example's loss through the JAX `Trainer`: the same
    weights, the same uint8 batches, and JAX's augmentation draws handed to
    the port's apply steps.  Loss of every step <= 1e-4 relative, final
    params <= 1e-5."""
    args = _args(tmp_path, "--dtype", "f32", "--steps", "3")
    data = tsyn.generate_batch(range(12), size=64)
    batches = list(itertools.islice(tsyn.corpus_batches(data, 4, seed=0, uint8=True), 3))
    jcfg = JCfg(**ps.PRESETS["small"], layerscale_value=args.layerscale, policy=j_parity())
    jmodel = JCls(jcfg, num_labels=5)
    rng = jax.random.PRNGKey(0)
    params = jmodel.init({"params": rng}, jnp.zeros((1, 64, 64, 3)))["params"]

    def jloss(p, batch, key):
        k_aug, k_flip, _ = jax.random.split(key, 3)
        pix = batch["pixel_values"].astype(jnp.float32) / 127.5 - 1.0
        images = jaug.random_flip(k_flip, jaug.random_brightness_contrast(k_aug, pix))
        logits = jmodel.apply({"params": p}, images)
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["labels"]))
        return loss, {"loss": loss}

    sched = optax.warmup_cosine_decay_schedule(0.0, args.lr, warmup_steps=1, decay_steps=3)
    jopt = optax.chain(optax.clip_by_global_norm(args.clip),
                       optax.adamw(sched, weight_decay=args.weight_decay))
    jtr = JTrainer(jloss, jopt, params, monitor=True, log_every=1, donate=False,
                   metrics_path=str(tmp_path / "j.jsonl"))
    jtr.fit(({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
            num_steps=3, rng=rng)

    # JAX's draws of step s, fed to the port's apply steps
    draws = []
    for s in range(3):
        k_aug, k_flip, _ = jax.random.split(jax.random.fold_in(rng, s), 3)
        kb, kc = jax.random.split(k_aug)
        draws.append({
            "flip": np.asarray(jax.random.bernoulli(k_flip, 0.5, (4, 1, 1, 1))).reshape(4),
            "brightness": 1.0 + np.asarray(jax.random.uniform(kb, (4,), minval=-0.2, maxval=0.2)),
            "contrast": 1.0 + np.asarray(jax.random.uniform(kc, (4,), minval=-0.2, maxval=0.2)),
        })
    bc, flips = iter(draws), iter(draws)
    monkeypatch.setattr(taug, "draw_brightness_contrast", lambda g, b, *a: {
        k: torch.from_numpy(v.copy()) for k, v in next(bc).items() if k != "flip"})
    monkeypatch.setattr(taug, "draw_flip", lambda g, b: {
        "flip": torch.from_numpy(next(flips)["flip"].copy())})

    cfg = ps.model_config(args)
    assert cfg.hidden_dropout_prob == 0.1  # the example's; off below, as in JAX's apply
    model = TCls(dataclasses.replace(cfg, hidden_dropout_prob=0.0), 5)
    model.load_state_dict(classifier_params_from_jax(params), strict=True)
    opt = make_optimizer(ps.warmup_cosine(args.lr, 1, 3), weight_decay=args.weight_decay,
                         clip_norm=args.clip)
    tr = Trainer(ps.loss_fn, opt, model.train(), monitor=True, log_every=1,
                 metrics_path=str(tmp_path / "t.jsonl"))
    tr.fit(({k: torch.from_numpy(v) for k, v in b.items()} for b in batches),
           num_steps=3, seed=0)

    jrec = [json.loads(line) for line in open(tmp_path / "j.jsonl")]
    trec = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert [r["step"] for r in trec] == [1, 2, 3]
    for a, b in zip(trec, jrec):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)
        assert a["grads_finite"] == b["grads_finite"] == 1.0
    want = classifier_params_from_jax(jtr.params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(_np(p), want[n].numpy(), atol=1e-5, rtol=0, err_msg=n)


def test_example_cli_on_the_cpu_and_bootstrap(tmp_path, monkeypatch):
    """`main(--device cpu --preset small --steps 2)` with an in-memory
    corpus in place of the JPEG one: metrics, summary, checkpoint; then
    `train_multistate --ckpt` starts from that trunk (bit-equal after the
    transfer) and takes two steps."""
    made = {}

    def in_memory(out_dir, num_images, size, seed, label_mode, max_objects):
        made["args"] = (num_images, size, seed, label_mode, max_objects)
        return tsyn.generate_batch(range(num_images), size=size, label_mode=label_mode,
                                   max_objects=max_objects)

    monkeypatch.setattr(ps, "ensure_corpus", in_memory)
    summary = ps.main(["--device", "cpu", "--preset", "small", "--steps", "2", "--batch", "4",
                       "--corpus-size", "8", "--eval-size", "8", "--qk-norm",
                       "--label-mode", "texture", "--out", str(tmp_path)])
    assert made["args"] == (8, 64, 0, "texture", 3)
    run = tmp_path / "pretrain_small_texture"
    assert json.load(open(run / "summary.json")) == summary
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert 0.0 <= summary["holdout_top1"] <= 1.0
    rec = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert rec[-1]["step"] == 2 and rec[-1]["grads_finite"] == 1.0
    params = restore_checkpoint(str(run / "ckpt"))["params"]
    assert "vit.encoder.layer.1.attention.q_norm.weight" in params

    seen = {}
    load = tms.load_pretrained_trunk

    def spy(model, ckpt):
        load(model, ckpt)
        seen.update({k: v.clone() for k, v in model.encoder.state_dict().items()})

    monkeypatch.setattr(tms, "load_pretrained_trunk", spy)
    losses = tms.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--preset", "small",
                       "--qk-norm", "--num-sample", "8", "--labels", "4",
                       "--ckpt", str(run / "ckpt")])
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    for i in range(2):
        for name in ("attention.qkv.weight", "attention.q_norm.weight", "mlp.fc2.bias"):
            assert torch.equal(seen[f"backbone.layer.{i}.{name}"],
                               params[f"vit.encoder.layer.{i}.{name}"])
    assert torch.equal(seen["embeddings.position_embeddings"],
                       params["vit.embeddings.position_embeddings"][:, 1:])
    assert torch.equal(seen["backbone.transmitter_token"],
                       params["vit.embeddings.cls_token"][0, 0])


def test_examples_raise_without_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.main(["--preset", "small", "--steps", "1", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # raised before the corpus was written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.pretrain(ps.build_parser().parse_args(["--preset", "small", "--out", str(tmp_path)]),
                    tsyn.generate_batch(range(4), size=64))
