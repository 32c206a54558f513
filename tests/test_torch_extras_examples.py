"""PyTorch port, the examples that wait on the base extras (CPU, tiny
configs, `--device cpu`): `multistate_inference`, `train_predictive`,
`train_subsample` and `train_multistate --pretrained` from a local HF
checkpoint (a random `transformers.ViTModel` saved to disk: nothing is
downloaded), `spectral_debug` (its figures and labellings), and
`train_multistate_synthetic` from a `pretrain_synthetic --preset small`
checkpoint made on an in-memory corpus.  Without a card each of them
raises unless `--device cpu` is given."""

import json

import numpy as np
import pytest
import torch

from msvit_tpu_torch.data import synthetic as tsyn
from msvit_tpu_torch.examples import multistate_inference, spectral_debug
from msvit_tpu_torch.examples import pretrain_synthetic as ps
from msvit_tpu_torch.examples import train_multistate, train_multistate_synthetic
from msvit_tpu_torch.examples import train_predictive, train_subsample
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import MultiStateViTConfig
from msvit_tpu_torch.models.predictive import PredictiveViTConfig
from msvit_tpu_torch.models.subsample import SubsampleViTConfig

TRUNK = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A random HF ViT (64 wide, 3 layers, patch 8 @32) saved in HF layout."""
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(0)
    model = ViTModel(ViTConfig(**TRUNK, intermediate_size=256, image_size=32, patch_size=8,
                               layer_norm_eps=1e-6), add_pooling_layer=False)
    path = tmp_path_factory.mktemp("hf_vit")
    model.save_pretrained(str(path))
    return str(path), model.state_dict()


def _ms_config():
    return MultiStateViTConfig(**TRUNK, image_size=32, patch_size=8, pregeneration_period=1,
                               generation_period=1,
                               clustering=SpectralClusteringConfig(ncut_dim=4, num_sample=16,
                                                                   max_clusters=4))


def test_multistate_inference_with_and_without_the_checkpoint(hf_dir, capsys):
    out = multistate_inference.main(["--device", "cpu", "--batch", "2"], config=_ms_config())
    assert tuple(out["cluster_tokens"].shape) == (2, 4, 64)
    pre = multistate_inference.main(["--device", "cpu", "--batch", "2", "--pretrained",
                                     hf_dir[0]], config=_ms_config())
    assert torch.isfinite(pre["last_hidden_state"]).all()
    assert not torch.equal(pre["last_hidden_state"], out["last_hidden_state"])
    printed = capsys.readouterr().out
    assert printed.count("num_clusters:") == 2 and "(2, 4, 4, 4)" in printed


def test_train_multistate_pretrained(hf_dir, monkeypatch):
    """`--pretrained DIR`: the encoder's trunk is the checkpoint's (TX and
    RX its CLS token), then two steps."""
    seen = {}
    real = train_multistate.import_into_multistate

    def spy(sd, cfg, state):
        seen.update(real(sd, cfg, state))
        return seen

    monkeypatch.setattr(train_multistate, "import_into_multistate", spy)
    losses = train_multistate.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                    "--labels", "4", "--pretrained", hf_dir[0]],
                                   _ms_config())
    assert len(losses) == 2 and all(np.isfinite(losses))
    sd = hf_dir[1]
    assert torch.equal(seen["backbone.transmitter_token"], sd["embeddings.cls_token"][0, 0])
    assert torch.equal(seen["backbone.layer.2.attention.qkv.weight"][:64],
                       sd["encoder.layer.2.attention.attention.query.weight"])


def test_train_predictive_pretrained(hf_dir, capsys):
    cfg = PredictiveViTConfig(**TRUNK, image_size=32, patch_size=16, max_context_length=3,
                              use_cls_token=False, patch_config="scaling",
                              default_patch_scale=0.4,
                              patch_config_scale=((1.0, 0.0), (1.0, 0.0), (1.0, -1.0)),
                              expected_context_length=2.0)
    losses = train_predictive.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                    "--pretrained", hf_dir[0]], config=cfg)
    assert len(losses) == 2 and all(np.isfinite(losses))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iter 0: loss ") and "query_patch_prediction=" in lines[0]
    assert lines[-1] == "done"


def test_train_subsample_pretrained_and_its_figure(hf_dir, tmp_path, monkeypatch, capsys):
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.chdir(tmp_path)
    cfg = SubsampleViTConfig(**TRUNK, image_size=32, patch_size=8, initial_grid_size=2,
                             max_depth=1, num_labels=5)
    losses = train_subsample.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                                   "--visualize-every", "1", "--pretrained", hf_dir[0]],
                                  config=cfg)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "subsample_0.png").exists() and (tmp_path / "subsample_1.png").exists()
    assert "iter 0: normalized loss" in capsys.readouterr().out


def test_spectral_debug_example(tmp_path):
    """The example's figures and labellings (20 t-SNE iterations): the
    labellings split the synthetic grid's halves (HDBSCAN's on the points
    it does not call noise)."""
    labels = spectral_debug.main([str(tmp_path), "--device", "cpu"], tsne_iters=20)
    g = np.broadcast_to((np.arange(28) >= 14).astype(int), (3, 28, 28)).reshape(-1)
    for name, lab in labels.items():
        kept = lab >= 0
        agree = (lab[kept] == g[kept]).mean()
        assert kept.any() and max(agree, 1.0 - agree) > 0.95, name
    written = sorted(p.name for p in tmp_path.glob("spectral_*.png"))
    assert written == ["spectral_eigs.png", "spectral_labels.png", "spectral_tsne0.png",
                       "spectral_tsne1.png", "spectral_tsne2.png"]


def test_train_multistate_synthetic_small(tmp_path, monkeypatch):
    """A `--preset small` pretrain checkpoint (2 steps on an in-memory
    corpus), then the cluster-vs-region scores of the trained trunk, the
    untrained one and a random partition, and the triptych figure."""
    def in_memory(out_dir, num_images, size, seed, label_mode, max_objects):
        return tsyn.generate_batch(range(num_images), size=size, label_mode=label_mode,
                                   max_objects=max_objects)

    monkeypatch.setattr(ps, "ensure_corpus", in_memory)
    ps.main(["--device", "cpu", "--preset", "small", "--steps", "2", "--batch", "4",
             "--corpus-size", "8", "--eval-size", "8", "--out", str(tmp_path)])
    summary = train_multistate_synthetic.main(
        ["--device", "cpu", "--preset", "small", "--eval-size", "4", "--batch", "2",
         "--out", str(tmp_path)])
    run = tmp_path / "multistate"
    assert json.load(open(run / "summary.json")) == summary
    for k in ("trained", "untrained", "random"):
        assert -1.0 <= summary[k]["ari"] <= 1.0 and 0.0 <= summary[k]["nmi"] <= 1.0
    assert 1.0 <= summary["trained"]["clusters"] <= 4.0
    assert (run / "clusters.png").stat().st_size > 0


def test_region_labels_are_patch_majorities():
    regions = np.zeros((1, 4, 4), np.uint8)
    regions[0, :2, :2] = 1
    regions[0, 0, 2] = 2  # a minority pixel of the second patch
    got = train_multistate_synthetic.patch_region_labels(regions, 2)
    np.testing.assert_array_equal(got, [[1, 0, 0, 0]])


def test_new_examples_refuse_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((multistate_inference.main, []), (train_predictive.main, []),
                       (train_subsample.main, []), (spectral_debug.main, [str(tmp_path)]),
                       (train_multistate_synthetic.main, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
