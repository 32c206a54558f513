"""PyTorch port, the debug tools (CPU) against the JAX package: HDBSCAN (the
MST, labels against JAX's and `sklearn.cluster.HDBSCAN`'s, the HDBNCUT
sampler), t-SNE (P, KL and its gradient, the optimizer from the same
start), `spectral_debug_labels` (JAX's draws through `JaxRng`, JAX's
eigensolver through `jax_eigh`), the utils, and every figure of `viz.py`
written as a PNG under the Agg backend."""

from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu import utils as jutils
from msvit_tpu.models.clustering import spectral_debug_labels as j_debug_labels
from msvit_tpu.ops import hdbscan as jh
from msvit_tpu.ops import tsne as jt
from msvit_tpu.utils import arrays as jarrays
from msvit_tpu_torch import utils as tutils
from msvit_tpu_torch.models.clustering import spectral_debug_labels
from msvit_tpu_torch.ops import hdbscan as th
from msvit_tpu_torch.ops import tsne as tt
from msvit_tpu_torch.utils import arrays as tarrays
from msvit_tpu_torch.utils import profiling

sklearn_cluster = pytest.importorskip("sklearn.cluster")

P_TOL = 1e-6  # t-SNE joint probabilities, f32
KL_TOL = 1e-5  # KL and its gradient, f32
# the embedding 5 iterations from one start, 1e-4 of its extent: the early-
# exaggeration steps amplify the packages' f32 roundings (measured on this
# data: 9e-6 after 1 step, 3.7e-5 after 5, 1.8e-3 after 10, O(1) after 20,
# where the runs have become different embeddings)
EMBED_ITERS = 5
EMBED_REL_TOL = 1e-4
# HDBSCAN probabilities: ratios of inverse MST weights, which the Gram
# trick's f32 distances put ~1e-5 apart between the two BLAS: up to 3e-4
# apart on these data (measured), where the distances are small
PROB_TOL = 1e-3


class JaxRng:
    """The port's `Rng` over a `jax.random` key (JAX's draws)."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [JaxRng(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape, lo, hi, device):
        u = jax.random.uniform(self.key, tuple(shape), minval=lo, maxval=hi)
        return torch.from_numpy(np.array(u)).to(device)

    def normal(self, shape, device):
        z = jax.random.normal(self.key, tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(z)).to(device)


@pytest.fixture
def jax_eigh(monkeypatch):
    """`torch.linalg.eigh` answered by `jnp.linalg.eigh` (JAX's signs)."""
    def eigh(a):
        w, v = jnp.linalg.eigh(jnp.asarray(a.detach().cpu().numpy()))
        return (torch.from_numpy(np.array(w)).to(a.device),
                torch.from_numpy(np.array(v)).to(a.device))
    monkeypatch.setattr(torch.linalg, "eigh", eigh)


def _blobs(rng, centers, n_per, scale=0.4, d=2):
    pts = [c + scale * rng.standard_normal((n_per, d)) for c in centers]
    return np.concatenate(pts, axis=0).astype(np.float32)


# ------------------------------------------------------------------ HDBSCAN


def test_mst_matches_jax():
    """The same edges in the same (Prim) order, weights within 1e-5."""
    x = np.random.default_rng(0).standard_normal((80, 5)).astype(np.float32)
    js, jd, jw = jh.mutual_reachability_mst(jnp.asarray(x), min_samples=5)
    ts, td, tw = th.mutual_reachability_mst(torch.from_numpy(x), min_samples=5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)


def _noisy_blobs():
    rng = np.random.default_rng(2)
    blobs = _blobs(rng, [np.array([0, 0]), np.array([8, 8])], 120, scale=0.3)
    noise = rng.uniform(-4, 12, size=(60, 2)).astype(np.float32)
    return np.concatenate([blobs, noise], axis=0)


@pytest.mark.parametrize("case", ["blobs-20", "blobs-15-5", "blobs-10-10", "noise-25"])
def test_labels_match_jax_and_sklearn(case):
    """Labels equal to JAX's and to sklearn's; probabilities within
    PROB_TOL of JAX's."""
    if case == "noise-25":
        x, mcs, ms = _noisy_blobs(), 25, None
    else:
        rng = np.random.default_rng(1)
        x = _blobs(rng, [np.array([0, 0]), np.array([6, 0]), np.array([0, 6])], 100)
        mcs, ms = {"blobs-20": (20, None), "blobs-15-5": (15, 5),
                   "blobs-10-10": (10, 10)}[case]
    got = th.hdbscan(torch.from_numpy(x), mcs, ms)
    want = jh.hdbscan(jnp.asarray(x), mcs, ms)
    ref = sklearn_cluster.HDBSCAN(min_cluster_size=mcs, min_samples=ms, copy=True).fit(
        np.asarray(x, np.float64))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_array_equal(got.labels, ref.labels_)
    np.testing.assert_allclose(got.probabilities, np.asarray(want.probabilities),
                               atol=PROB_TOL, rtol=0)
    assert got.labels.max() >= 1


def test_hdbncut_sampler_draws_jax_clustered_set():
    """Up to `num_sample` distinct indices, all clustered; with a budget
    above the clustered count, exactly JAX's clustered set."""
    rng = np.random.default_rng(3)
    blobs = _blobs(rng, [np.zeros(8), np.full(8, 10.0)], 150, scale=0.3, d=8)
    noise = rng.uniform(-5, 15, size=(40, 8)).astype(np.float32)
    x = np.concatenate([blobs, noise], axis=0)
    kw = dict(cluster_size_threshold=0.2, min_samples=20)
    idx = th.hdbncut_sample_indices(torch.from_numpy(x), 64, JaxRng(jax.random.PRNGKey(0)),
                                    **kw)
    assert idx.shape == (64,) and len(set(idx.tolist())) == 64
    full = th.hdbncut_sample_indices(x, 10_000, JaxRng(jax.random.PRNGKey(0)), **kw)
    want = jh.hdbncut_sample_indices(x, 10_000, jax.random.PRNGKey(0), **kw)
    assert sorted(full.tolist()) == sorted(np.asarray(want).tolist())
    assert set(idx.tolist()) <= set(full.tolist()) and len(full) < len(x)


# -------------------------------------------------------------------- t-SNE


def _clusters(seed=0, n_per=30, d=10, k=3):
    rng = np.random.default_rng(seed)
    centers = 8.0 * rng.standard_normal((k, d))
    return np.concatenate([c + rng.standard_normal((n_per, d)) for c in centers],
                          0).astype(np.float32)


@pytest.mark.parametrize("perplexity", [10.0, 25.0])
def test_joint_probabilities_match_jax(perplexity):
    x = np.random.default_rng(0).standard_normal((60, 8)).astype(np.float32)
    got = tt.joint_probabilities(torch.from_numpy(x), perplexity).numpy()
    want = np.asarray(jt.joint_probabilities(jnp.asarray(x), perplexity))
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)


@pytest.mark.parametrize("exaggeration", [12.0, 1.0])
def test_kl_and_grad_match_jax(exaggeration):
    x = _clusters()
    p = jt.joint_probabilities(jnp.asarray(x), 20.0)
    y = np.random.default_rng(1).standard_normal((len(x), 2)).astype(np.float32)
    jkl, jg = jt._kl_and_grad(jnp.asarray(y), p, jnp.float32(exaggeration))
    tkl, tg = tt._kl_and_grad(torch.from_numpy(y), torch.from_numpy(np.array(p)), exaggeration)
    assert abs(float(tkl) - float(jkl)) <= KL_TOL * max(1.0, abs(float(jkl)))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=KL_TOL, rtol=0)


def test_tsne_from_the_same_start_matches_jax():
    """`tsne(init="random")` with JAX's draw: EMBED_ITERS iterations under
    early exaggeration, the embedding within EMBED_REL_TOL of its extent
    and the KL trace within 1e-4 relative."""
    x = _clusters(seed=4)
    kw = dict(dim=2, perplexity=15.0, n_iter=EMBED_ITERS, exaggeration_iters=30,
              init="random")
    jy, jkl = jt.tsne(jnp.asarray(x), key=jax.random.PRNGKey(3), **kw)
    ty, tkl = tt.tsne(torch.from_numpy(x), key=JaxRng(jax.random.PRNGKey(3)), **kw)
    jy = np.asarray(jy)
    extent = np.abs(jy).max()
    np.testing.assert_allclose(ty.numpy(), jy, atol=EMBED_REL_TOL * extent, rtol=0)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), rtol=1e-4, atol=0)
    assert tkl.shape == (EMBED_ITERS,)


def test_tsne_pca_init_separates_clusters():
    """The PCA start (signs are the eigensolver's): three well-separated
    clusters stay apart in 2-D and in 3-D."""
    x = _clusters(seed=5)
    labels = np.repeat(np.arange(3), 30)
    for dim in (2, 3):
        y, kl = tt.tsne(torch.from_numpy(x), dim=dim, perplexity=15.0, n_iter=150,
                        exaggeration_iters=75)
        y = y.numpy()
        d = ((y[:, None] - y[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        assert (labels[d.argmin(1)] == labels).mean() > 0.95
        assert np.isfinite(kl.numpy()).all() and y.shape == (90, dim)
    with pytest.raises(ValueError, match="key"):
        tt.tsne(torch.from_numpy(x), init="random")


# ------------------------------------------------------------ debug labels


def test_spectral_debug_labels_match_jax(jax_eigh):
    """Every labelling equal to JAX's on cosine-separable blobs, from JAX's
    draws and eigensolver."""
    rng = np.random.default_rng(3)
    c1, c2 = 4.0 * np.eye(6)[0], 4.0 * np.eye(6)[1]
    x = np.concatenate([c + 0.3 * rng.standard_normal((100, 6)) for c in (c1, c2)]
                       ).astype(np.float32)
    kw = dict(cluster_size_threshold=0.05, min_samples=8)
    want = j_debug_labels(jnp.asarray(x), jax.random.PRNGKey(0), **kw)
    got = spectral_debug_labels(torch.from_numpy(x), JaxRng(jax.random.PRNGKey(0)), **kw)
    assert list(got) == list(want) == ["hdbscan", "km_boosted_spectral", "km_spectral",
                                       "aa_boosted_spectral", "aa_spectral"]
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    assert got["hdbscan"].max() == 1


# -------------------------------------------------------------------- utils


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0.1, 0.5, shape).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_math_helpers_match_jax():
    m = _rand((5, 5), 0) / 2
    np.testing.assert_allclose(tutils.pow_series(*_t(m), 6).numpy(),
                               np.asarray(jutils.pow_series(jnp.asarray(m), 6)), rtol=1e-5)
    assert tutils.pow_series(*_t(m), 1).shape == (1, 5, 5)
    b = _rand((3, 4, 4), 1)
    np.testing.assert_allclose(tutils.batch_trace(*_t(b)).numpy(),
                               np.asarray(jutils.batch_trace(jnp.asarray(b))), rtol=1e-6)
    a = np.random.default_rng(2).standard_normal((2, 4, 4)).astype(np.float32)
    cov1 = a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32)
    cov2 = cov1[::-1].copy()
    np.testing.assert_allclose(tutils.gaussian_kl(*_t(cov1, cov2)).numpy(),
                               np.asarray(jutils.gaussian_kl(jnp.asarray(cov1),
                                                             jnp.asarray(cov2))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tutils.sqrtm(*_t(cov1)).numpy(),
                               np.asarray(jutils.sqrtm(jnp.asarray(cov1))), rtol=1e-4, atol=1e-5)
    assert tutils.ceildiv(7, 2) == jutils.ceildiv(7, 2) == 4
    m, n, p_, q_ = 2, 3, 2, 2
    a, alpha, bb, beta, beta2, c = (_rand(s, i) for i, s in enumerate(
        [(m, n), (m, n), (p_, q_), (p_, q_), (p_, q_), (m, p_)]))
    for fn, args in (("hadamard_conjugation", (a, bb, alpha, beta, c)),
                     ("hadamard_conjugation_diff_order1", (a, bb, alpha, beta, beta2, c)),
                     ("hadamard_conjugation_diff_order2", (bb, beta, beta2, c))):
        got = getattr(tutils, fn)(*_t(*args)).numpy()
        want = np.asarray(getattr(jutils, fn)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=fn)


def test_inverse_cubic_and_its_gradient_match_jax():
    t = np.linspace(-3.0, 3.0, 41, dtype=np.float32)
    tt_ = torch.from_numpy(t).requires_grad_(True)
    y = tutils.inverse_cubic(tt_)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(41).astype(np.float32))
    (y * g).sum().backward()
    jy, vjp = jax.vjp(jutils.inverse_cubic, jnp.asarray(t))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt_.grad.numpy(), np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                               rtol=1e-5, atol=1e-6)


def test_tree_helpers_match_jax():
    trees = [{"a": np.full((2,), i, np.float32), "b": [np.full((3, 1), -i, np.float32)]}
             for i in range(4)]
    got = tutils.stack_pytrees([jax.tree.map(torch.from_numpy, t) for t in trees])
    want = jutils.stack_pytrees(trees)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    nested = {"x": {"y": 1, "z": {"w": 2}}, "v": 3}
    assert tutils.flatten_nested_dict(nested) == jutils.flatten_nested_dict(nested)
    cfg = {"hidden": 64, "layers": [1, 2], "name": "vit"}
    assert tutils.hash_config(cfg) == jutils.hash_config(cfg)
    assert tutils.hash_config({**cfg, "hidden": 65}) != tutils.hash_config(cfg)


def test_model_size_and_timers():
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel

    model = ViTModel(BaseViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                   image_size=32, patch_size=16))
    n = sum(p.numel() for p in model.parameters())
    assert tutils.model_size(model) == tutils.model_size(model.state_dict()) == n
    with tutils.Timer() as t:
        sum(range(1000))
    assert t.duration >= 0.0
    profiling.reset()
    with profiling.record():
        for _ in range(2):
            with profiling.span("a", device=torch.zeros(1).device):
                pass
    row = profiling.summary()
    profiling.reset()
    assert list(row) == ["a"] and row["a"]["count"] == 2 and row["a"]["host_ms"] >= 0.0


def test_arrays_helpers_match_jax(capsys):
    arr = np.arange(6).reshape(2, 3)
    for mod in (jarrays, tarrays):
        assert list(mod.multi_iter(arr)) == list(range(6))
        np.testing.assert_array_equal(mod.multi_map(lambda v: v * 2, arr), arr * 2)
        assert [i for i, _ in mod.multi_enumerate(arr)][-1] == (1, 2)
        assert list(mod.PTR(5)) == [5] and mod.array_of([1, 2])[()] == [1, 2]
        assert mod.nested_type({"a": [1, "x"]}) == {"a": [int, str]}
        assert mod.map_dict({"a": {"b": 2}}, lambda v: v + 1) == {"a": {"b": 3}}
        ns = Namespace(a=1, sub=Namespace(b=2))
        assert mod.nested_vars(ns) == {"a": 1, "sub.b": 2}
        assert mod.call_func_with_kwargs(lambda x, y=0: x + y, (1,), {"y": 2, "z": 3}) == 3
        with mod.print_disabled():
            print("hidden")
        rec = mod.multi_zip(np.arange(2), np.ones(2))
        assert rec.f1.tolist() == [1.0, 1.0]
    assert "hidden" not in capsys.readouterr().out


# --------------------------------------------------------------------- viz


@pytest.fixture
def agg():
    import matplotlib

    matplotlib.use("Agg")


def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_viz_helpers_and_tsne_scatter(agg, tmp_path):
    from matplotlib import pyplot as plt

    from msvit_tpu import viz as jviz
    from msvit_tpu_torch import viz

    for z in (0.0, 37.5, 200.0):
        np.testing.assert_allclose(viz.color(z), jviz.color(z))
    fig, ax = plt.subplots()
    x = torch.randn(50, generator=torch.Generator().manual_seed(0))
    viz.confidence_ellipse(x, 0.5 * x + 0.1, ax, edgecolor="red")
    fig.savefig(tmp_path / "ellipse.png")
    plt.close(fig)
    assert _png(tmp_path / "ellipse.png")
    feats = torch.from_numpy(_clusters(seed=6, n_per=10))
    for dim in (2, 3):
        viz.visualize_tsne_clusters(feats, labels=torch.arange(30) // 10, dim=dim,
                                    perplexity=5.0, show=False,
                                    save_path=tmp_path / f"tsne{dim}.png")
        assert _png(tmp_path / f"tsne{dim}.png")


def test_visualize_spectral_debug_writes_pngs(agg, tmp_path):
    from msvit_tpu_torch.ops.ncut import ncut
    from msvit_tpu_torch.utils.rng import Rng
    from msvit_tpu_torch.viz import visualize_spectral_debug

    rng = np.random.default_rng(0)
    bsz, h, w, d = 2, 6, 6, 16
    centers = 6.0 * rng.standard_normal((2, d)).astype(np.float32)
    g = np.broadcast_to((np.arange(w) >= w // 2).astype(int), (bsz, h, w)).reshape(bsz, -1)
    x = centers[g] + rng.standard_normal((bsz, h * w, d)).astype(np.float32)
    ncut_x, _ = ncut(torch.from_numpy(x.reshape(-1, d)), num_eig=4, key=Rng(0))
    figs, labels = visualize_spectral_debug(
        ncut_x.reshape(bsz, h * w, 4), grid=(h, w), images=2, min_samples=8,
        tsne_iters=20, show=False, save_prefix=str(tmp_path / "sd"))
    assert len(figs) == 2 + 2 and "hdbscan" in labels
    for name in ("sd_eigs.png", "sd_labels.png", "sd_tsne0.png", "sd_tsne1.png"):
        assert _png(tmp_path / name), name
    with pytest.raises(ValueError, match="tile"):
        visualize_spectral_debug(ncut_x.reshape(bsz, h * w, 4), grid=(5, 5), show=False)


def test_visualize_subsample_and_predictive_write_pngs(agg, tmp_path):
    from msvit_tpu_torch.models.predictive import PredictiveViTConfig, PredictiveViTModel
    from msvit_tpu_torch.models.predictive import PredictiveViTTrainingConfig, training_loss
    from msvit_tpu_torch.models.subsample import (
        SubsampleViTConfig, SubsampleViTForImageClassification)
    from msvit_tpu_torch.utils.rng import Rng
    from msvit_tpu_torch.viz import visualize_predictive_sample, visualize_subsample_output

    small = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, image_size=32)
    scfg = SubsampleViTConfig(**small, patch_size=8, initial_grid_size=2, max_depth=1,
                              num_labels=3)
    model = SubsampleViTForImageClassification(scfg).eval()
    pix = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(pix, rng=Rng(0), output_logs=True, return_pixel_values=True)
    visualize_subsample_output(out, model.model.tree, num_ims=2, show=False,
                               save_path=tmp_path / "quadtree.png")
    assert _png(tmp_path / "quadtree.png")

    pcfg = PredictiveViTConfig(**small, patch_size=16, max_context_length=3)
    pmodel = PredictiveViTModel(pcfg).eval()
    tc = PredictiveViTTrainingConfig(positional_recovery=1.0)
    with torch.no_grad():
        pout = pmodel(pix, rng=Rng(2), output_inputs=True)
        _, _, meta = training_loss(pmodel, pix, pout, tc)
    visualize_predictive_sample(pix, pout, meta, pmodel, num_ims=3, show=False,
                                save_path=tmp_path / "glimpses.png")
    assert _png(tmp_path / "glimpses.png")
