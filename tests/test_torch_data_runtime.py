"""The port's data runtime against the JAX package's, on the CPU: the
dataset registry, the resumable sampler (Feistel order, epochs, shards),
mid-epoch resume through the CPU prefetch, a `Trainer` resume that
reproduces the uninterrupted run, the digits fixture (arrays, split,
epochs, eval batches) and `load_image_batches` over a local image folder
(offline), at prefetch 0 and through the uint8 wire with the normalization
on the device.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from msvit_tpu.data import digits as jdigits
from msvit_tpu.data import pipeline as jpipe
from msvit_tpu.data import registry as jregistry
from msvit_tpu.data import resumable as jres
from msvit_tpu_torch.data import digits as tdigits
from msvit_tpu_torch.data import pipeline as tpipe
from msvit_tpu_torch.data import registry as tregistry
from msvit_tpu_torch.data import resumable as tres
from msvit_tpu_torch.train import Trainer, make_optimizer


def test_registry_equals_jax():
    assert tregistry.DATASETS == jregistry.DATASETS
    assert tregistry.dataset_names() == jregistry.dataset_names()
    for domain in jregistry.DATASETS:
        assert tregistry.dataset_names(domain) == jregistry.dataset_names(domain)


@pytest.mark.parametrize("n,key", [(1, 3), (2, 0), (7, 5), (64, 123), (1000, 2**40 + 7),
                                   (4097, 2**64 - 1)])
def test_feistel_permutation_equals_jax(n, key):
    idx = np.arange(n)
    got = tres.feistel_permutation(idx, n, key)
    np.testing.assert_array_equal(got, jres.feistel_permutation(idx, n, key))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("n,bs,seed,shard,shards,shuffle", [
    (100, 8, 7, 0, 1, True), (64, 4, 3, 2, 4, True), (1797, 128, 0, 0, 1, True),
    (50, 5, 9, 1, 2, False)])
def test_index_sampler_equals_jax(n, bs, seed, shard, shards, shuffle):
    """Three epochs of batch indices, element for element, and the state
    after them."""
    kw = dict(num_examples=n, batch_size=bs, seed=seed, shuffle=shuffle,
              shard_index=shard, shard_count=shards, num_epochs=3)
    got, want = tres.IndexSampler(**kw), jres.IndexSampler(**kw)
    a, b = list(got), list(want)
    assert len(a) == len(b) == 3 * got.batches_per_epoch
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert got.state_dict() == want.state_dict()


def test_sampler_rejects_another_configuration():
    snap = tres.IndexSampler(num_examples=100, batch_size=8, seed=7).state_dict()
    with pytest.raises(ValueError, match="batch_size"):
        tres.IndexSampler(num_examples=100, batch_size=16, seed=7).load_state_dict(snap)


@pytest.mark.parametrize("prefetch", [0, 3])
def test_midepoch_resume_through_prefetch(prefetch):
    """13 batches, a snapshot, a fresh loader from it: the next 17 batches
    equal the uninterrupted run's (through the CPU prefetch thread too, the
    state riding each batch), and the uninterrupted run equals JAX's."""
    data = np.arange(100, dtype=np.float32)

    def fetch(idx):
        return {"x": data[idx]}

    def make(state=None):
        loader = tres.ResumableLoader(tres.IndexSampler(100, 8, seed=7), fetch,
                                      prefetch=prefetch, device="cpu")
        if state is not None:
            loader.load_state_dict(state)
        return loader

    ref = make()
    full = [np.asarray(next(ref)["x"]) for _ in range(30)]
    jax_loader = jres.ResumableLoader(jres.IndexSampler(100, 8, seed=7), fetch)
    np.testing.assert_array_equal(np.stack(full),
                                  np.stack([next(jax_loader)["x"] for _ in range(30)]))
    a = make()
    for _ in range(13):
        batch = next(a)
    assert isinstance(batch["x"], torch.Tensor if prefetch else np.ndarray)
    snap = a.state_dict()
    assert snap["epoch"] == 1 and snap["pos"] == 1  # 12 batches an epoch
    b = make(snap)
    rest = [np.asarray(next(b)["x"]) for _ in range(17)]
    np.testing.assert_array_equal(np.stack(full[13:]), np.stack(rest))
    with pytest.raises(RuntimeError, match="before consuming"):
        b.load_state_dict(snap)


class _Linear(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(3))


def _regression_loss(model, batch, gen):
    x = batch["x"]
    want = x @ torch.tensor([1.0, -2.0, 3.0])
    return ((x @ model.w - want) ** 2).mean(), {}


def test_trainer_resume_reproduces_uninterrupted_run(tmp_path):
    """As the JAX package's test: 12 steps straight equal 8 steps (the last
    checkpoint at 8), a fresh Trainer that restores the loader's position
    with its state, and 4 more: params and the loader's state bit for bit;
    the loader feeds through the CPU prefetch thread."""
    table = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)

    def loader():
        return tres.ResumableLoader(tres.IndexSampler(64, 8, seed=5),
                                    lambda idx: {"x": table[idx]}, prefetch=2, device="cpu")

    def train(steps, ckpt_dir, resume=False):
        tr = Trainer(_regression_loss, make_optimizer(0.1, 0.0), _Linear(),
                     checkpoint_dir=ckpt_dir, save_every=4)
        it = loader()
        if resume:
            assert tr.restore(it) == 8
            assert (it.state_dict()["epoch"], it.state_dict()["pos"]) == (0, 8)
        tr.fit(it, steps, seed=1)
        return tr, it

    ref, ref_it = train(12, str(tmp_path / "ref"))
    train(8, str(tmp_path / "ab"))
    resumed, it = train(12, str(tmp_path / "ab"), resume=True)
    assert resumed.step == 12
    assert torch.equal(resumed.model.w, ref.model.w)
    assert it.state_dict() == ref_it.state_dict()


@pytest.fixture(scope="module")
def digits():
    return (tdigits.load_digits_arrays(image_size=16, seed=1),
            jdigits.load_digits_arrays(image_size=16, seed=1))


def test_digits_equal_jax(digits):
    """Arrays, stratified split, shuffled epochs and eval batches."""
    got, want = digits
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["train_images"].shape[1:] == (16, 16, 3)
    a = list(tdigits.iter_epochs(got["train_images"], got["train_labels"], 128, seed=2,
                                 max_steps=25))
    b = list(jdigits.iter_epochs(want["train_images"], want["train_labels"], 128, seed=2,
                                 max_steps=25))
    assert len(a) == len(b) == 25  # two epochs and a bit
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    ea = list(tdigits.eval_batches(got["test_images"], got["test_labels"], 100))
    eb = list(jdigits.eval_batches(want["test_images"], want["test_labels"], 100))
    assert len(ea) == len(eb) and len(ea[-1]["labels"]) < 100
    for x, y in zip(ea, eb):
        for k in ("pixel_values", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
    with pytest.raises(ValueError, match="multiple of 8"):
        tdigits.load_digits_arrays(image_size=12)


@pytest.fixture
def image_folder(tmp_path, monkeypatch):
    """12 JPEGs in two class folders, of several sizes, written with PIL;
    `datasets` offline, its cache under tmp_path."""
    import datasets

    rng = np.random.default_rng(0)
    root = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir(parents=True)
        for i in range(6):
            h, w = 60 + 37 * i, 80 + 23 * c + 11 * i
            small = rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                root / cls / f"{i}.jpg", quality=90)
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for name in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        if hasattr(datasets.config, name):
            monkeypatch.setattr(datasets.config, name, True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", tmp_path / "hf")
    return str(root)


def test_load_image_batches_equals_jax(image_folder):
    """At prefetch 0 (host numpy, native f32 decode) equal to JAX's batch
    for batch; through the uint8 wire (prefetch to the CPU, the
    normalization by `preprocess_on_device`) within uint8 rounding (half a
    level: 0.5 / 127.5 normalized) of it, labels equal."""
    kw = dict(batch_size=4, config=None, prefetch=0)
    want = list(jpipe.load_image_batches(
        image_folder, **{**kw, "config": jpipe.ImagePipelineConfig(image_size=48)}))
    cfg = tpipe.ImagePipelineConfig(image_size=48)
    got = list(tpipe.load_image_batches(image_folder, **{**kw, "config": cfg}))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert isinstance(a["pixel_values"], np.ndarray)
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert sorted(np.concatenate([b["labels"] for b in got]).tolist()) == [0] * 6 + [1] * 6
    wire = list(tpipe.load_image_batches(image_folder, batch_size=4, config=cfg,
                                         prefetch=1, device="cpu"))
    assert len(wire) == 3
    for a, b in zip(wire, want):
        pix = a["pixel_values"]
        assert isinstance(pix, torch.Tensor) and pix.dtype == torch.float32
        assert float((pix - torch.from_numpy(b["pixel_values"])).abs().max()) <= 0.5 / 127.5 + 1e-5
        np.testing.assert_array_equal(np.asarray(a["labels"]), b["labels"])
    shuffled = list(tpipe.load_image_batches(image_folder, batch_size=4, config=cfg, prefetch=0,
                                             shuffle_seed=3))
    assert sorted(np.concatenate([b["labels"] for b in shuffled]).tolist()) == [0] * 6 + [1] * 6


def test_load_image_batches_names_its_dependency(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        tpipe.load_image_batches(os.devnull)


def test_data_package_exports_equal_jax():
    """`msvit_tpu_torch.data` exports what `msvit_tpu.data` does, and
    importing it loads none of scikit-learn, `datasets` or PIL (a fresh
    process)."""
    import subprocess
    import sys

    import msvit_tpu.data as jdata
    import msvit_tpu_torch.data as tdata

    def exports(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not isinstance(v, type(os))}

    assert exports(tdata) == exports(jdata)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", "import sys, msvit_tpu_torch.data; print(sorted(m for m in "
         "('sklearn', 'datasets', 'PIL', 'jax', 'msvit_tpu') if m in sys.modules))"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
