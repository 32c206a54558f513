"""The runtime's examples on the CPU at their smallest flags and tiny
configs: export -> reload -> serve, Poisson serving (int8 with the bf16
small buckets), the digits workflow (train, EMA, int8), the multistate
bootstrap on digits, the classifier eval (synthetic and an image folder),
the NCut comparison (its spectra against JAX's on JAX's draws), and
``--dataset`` of `train_multistate` and `train_saccadic` on an image folder
(offline).  Without ``--device cpu`` and without a card every one raises.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from msvit_tpu.ops.ncut import ncut as jncut
from msvit_tpu_torch.examples import (
    eval_classifier, export_serving, ncut_compare, serve_vit, train_digits,
    train_multistate, train_multistate_digits, train_saccadic)
from msvit_tpu_torch.models.base import BaseViTConfig
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import MultiStateViTConfig
from msvit_tpu_torch.models.saccadic import SaccadicViTConfig
from test_torch_clustering import JaxRng

CPU = ["--device", "cpu"]


def _vit(image_size=32, patch_size=16, layers=1, **kw) -> BaseViTConfig:
    return BaseViTConfig(hidden_size=32, num_hidden_layers=layers, num_attention_heads=2,
                         image_size=image_size, patch_size=patch_size, **kw)


def _multistate(image_size=16, patch_size=4) -> MultiStateViTConfig:
    return MultiStateViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=image_size,
        patch_size=patch_size, pregeneration_period=1, generation_period=1,
        clustering=SpectralClusteringConfig(ncut_dim=2, num_sample=8, max_clusters=4,
                                            eigenvalue_threshold=0.1, ncut_dist="rbf"))


@pytest.fixture
def image_folder(tmp_path, monkeypatch):
    """8 JPEGs in two class folders; `datasets` offline, its cache under
    tmp_path."""
    import datasets

    rng = np.random.default_rng(3)
    for cls in ("a", "b"):
        (tmp_path / "folder" / cls).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(
                tmp_path / "folder" / cls / f"{i}.jpg", quality=90)
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for name in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        if hasattr(datasets.config, name):
            monkeypatch.setattr(datasets.config, name, True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", tmp_path / "hf")
    return str(tmp_path / "folder")


def test_export_serving():
    """A 1-layer, 64-wide ViT at 224 px: exported, reloaded (equal to the
    live model), 4 requests served through buckets of 1 and 2."""
    out = export_serving.main(CPU + ["--hidden", "64", "--layers", "1", "--heads", "2",
                                     "--requests", "4", "--max-batch", "2"])
    assert out["max_abs_diff"] == 0.0 and out["dim"] == 64 and out["artifact_bytes"] > 0
    assert out["stats"]["requests"] == 4


def test_serve_vit_int8():
    """Poisson arrivals for 0.3 s into the int8 forward, buckets of 1 and 2
    routed to bf16: every response finite, of the trunk's width."""
    out = serve_vit.main(CPU + ["--mode", "int8", "--seconds", "0.3", "--rps", "40",
                                "--max-batch", "4", "--max-wait-ms", "2"], config=_vit())
    assert out["stats"]["requests"] >= 1 and out["finite"] and out["dim"] == 32


def test_train_digits():
    """Three steps of the digits workflow at 16 px: finite loss, raw / EMA
    / int8 accuracies in [0, 1]."""
    out = train_digits.main(CPU + ["--steps", "3", "--batch", "32"],
                            config=_vit(16, 4, hidden_dropout_prob=0.1))
    assert np.isfinite(out["final_loss"])
    for k in ("raw_top1", "ema_top1", "int8_top1"):
        assert 0.0 <= out[k] <= 1.0


def test_train_multistate_digits():
    """Two base steps, the transfer, two multistate steps with the trunk
    frozen: both accuracies in [0, 1]."""
    out = train_multistate_digits.main(
        CPU + ["--steps", "2", "--ms-steps", "2", "--batch", "16"],
        configs=(_vit(16, 4, layers=2), _multistate()))
    assert 0.0 <= out["base_top1"] <= 1.0 and 0.0 <= out["multistate_top1"] <= 1.0


def test_eval_classifier(image_folder):
    """Synthetic batches, then an image folder (labels from its classes):
    eval metrics and two augmented steps with finite losses."""
    out = eval_classifier.main(CPU + ["--batch", "4", "--eval-batches", "2", "--steps", "2"],
                               config=_vit())
    assert out["eval"]["n"] == 8 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    out = eval_classifier.main(CPU + ["--batch", "4", "--eval-batches", "3", "--steps", "1",
                                      "--dataset", image_folder], config=_vit())
    assert out["eval"]["n"] == 8  # two full batches of the 8 images
    assert np.isfinite(out["losses"][0])


def test_ncut_compare():
    """With JAX's draws the port's spectra equal JAX's (1e-4) under both
    affinities; the CLI runs, and rbf separates the blobs."""
    x = ncut_compare.blobs()
    key = jax.random.PRNGKey(0)
    res = ncut_compare.compare(torch.from_numpy(x), JaxRng(key))
    for name in ("rbf", "cosine"):
        _, want = jncut(jnp.asarray(x), num_eig=6, key=key, num_sample=256, distance=name)
        np.testing.assert_allclose(res[name]["eigvals"].numpy(), np.asarray(want), atol=1e-4)
    out = ncut_compare.main(CPU)
    assert out["rbf"]["within"] < out["rbf"]["gap"]


def test_dataset_flags_take_an_image_folder(image_folder):
    """`train_multistate --dataset` and `train_saccadic --dataset` train on
    the folder's first batch."""
    losses = train_multistate.main(CPU + ["--steps", "1", "--batch", "4", "--labels", "2",
                                          "--dataset", image_folder], _multistate(32, 8))
    assert len(losses) == 1 and np.isfinite(losses[0])
    cfg = SaccadicViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                            num_patterns=((1, 8), (2, 8)), covariance_dim=4, beam_size=4,
                            image_size=64, patch_size=16)
    res = train_saccadic.main(CPU + ["--steps", "1", "--batch", "2", "--glimpses", "4",
                                     "--context", "2", "--dataset", image_folder], config=cfg)
    assert np.isfinite(res["losses"][0])


def test_examples_refuse_without_a_card(monkeypatch):
    """No card and no `--device cpu`: each example raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: export_serving.main([]), lambda: serve_vit.main([], config=_vit()),
                lambda: train_digits.main([], config=_vit(16, 4)),
                lambda: train_multistate_digits.main([], configs=(_vit(16, 4, 2), _multistate())),
                lambda: eval_classifier.main([], config=_vit()),
                lambda: ncut_compare.main([])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            run()
