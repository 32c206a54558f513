"""PyTorch port, clustering: `ops/kmeans.py`, `ops/ncut.py` and the spectral
clustering module against the JAX package on the same numpy inputs (CPU).

Randomness: the port takes an `Rng` wherever JAX takes a key.  `JaxRng`
below has the same three methods over `jax.random`, so the port draws
JAX's numbers in JAX's order and both packages reach the same partition.
Inputs are drawn around well-separated centers, so that no partition sits
at a near tie."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import clustering as jcl
from msvit_tpu.ops.kmeans import kmeans as jkmeans
from msvit_tpu.ops.ncut import ncut as jncut
from msvit_tpu_torch.models import clustering as tcl
from msvit_tpu_torch.ops import ncut as tncut_mod
from msvit_tpu_torch.ops.kmeans import kmeans as tkmeans, top_k_indices
from msvit_tpu_torch.ops.ncut import ncut as tncut
from msvit_tpu_torch.utils.rng import Rng


class JaxRng:
    """The port's `Rng` interface over a `jax.random` key: the port then
    draws exactly the numbers the JAX package draws."""

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


def blobs(k=4, n_per=30, d=16, sep=4.0, seed=0):
    """k Gaussian blobs of n_per points around centers `sep` apart (std)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * sep
    x = np.concatenate([c + rng.standard_normal((n_per, d)) for c in centers])
    return x.astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------- Rng ----


def test_rng_streams_are_deterministic_and_distinct():
    r = Rng(7)
    a, b = r.split(2)
    assert a.seed == Rng(7).split(2)[0].seed and a.seed != b.seed
    u1, u2 = a.uniform((64,), 1e-9, 1.0, "cpu"), a.uniform((64,), 1e-9, 1.0, "cpu")
    assert torch.equal(u1, u2) and float(u1.min()) >= 1e-9 and float(u1.max()) < 1.0
    assert not torch.equal(u1, b.uniform((64,), 1e-9, 1.0, "cpu"))
    z = a.normal((4096,), "cpu")
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1.0) < 0.1


def test_rng_rows_equal_row_by_row_draws():
    """`uniform_rows` / `normal_rows` draw every key's row in one pass: equal
    to each key's own draw, and an element's draw does not depend on the
    draw's size (the first rows of a larger batch draw what a smaller one
    draws)."""
    from msvit_tpu_torch.utils.rng import normal_rows, uniform_rows

    keys = Rng(3).split(5)
    u = uniform_rows(keys, (4, 6), 1e-9, 1.0, "cpu")
    z = normal_rows(keys, (7,), "cpu")
    for i, k in enumerate(keys):
        assert torch.equal(u[i], k.uniform((4, 6), 1e-9, 1.0, "cpu"))
        assert torch.equal(z[i], k.normal((7,), "cpu"))
    assert torch.equal(keys[0].uniform((2, 6), 0.0, 1.0, "cpu"),
                       keys[0].uniform((5, 6), 0.0, 1.0, "cpu")[:2])


def test_child_counts_equal_the_scan():
    """The closed form of the children per parent (`child_counts`) against
    the scan it replaces (JAX's `lax.scan`: each parent's wish clamped to
    >= 1 and to the slots still free, in order), on random parents."""
    from msvit_tpu_torch.models.clustering.module import child_counts

    gen = torch.Generator().manual_seed(0)
    for _ in range(2000):
        c_bound = int(torch.randint(1, 17, (), generator=gen))
        c_max = int(torch.randint(1, 17, (), generator=gen))
        has = torch.rand(c_bound, generator=gen) < 0.7
        k_raw = torch.randint(0, 9, (c_bound,), generator=gen)
        cum, want, want_cums = torch.zeros((), dtype=torch.long), [], []
        for p in range(c_bound):
            k = torch.where(has[p], torch.minimum(k_raw[p].clamp_min(1),
                                                  (c_max - cum).clamp_min(1)), 0)
            want_cums.append(cum)
            want.append(k)
            cum = cum + k
        got, cums = child_counts(has, k_raw, c_max)
        assert torch.equal(got, torch.stack(want)) and torch.equal(cums, torch.stack(want_cums))


def test_jax_rng_adapter_draws_jax_numbers():
    key = jax.random.PRNGKey(3)
    got = JaxRng(key).split(3)[2].uniform((5,), 1e-9, 1.0, "cpu")
    want = jax.random.uniform(jax.random.split(key, 3)[2], (5,), minval=1e-9, maxval=1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- top-k ----


def test_top_k_ties_take_the_lower_index_first():
    """-inf ties (non-members) and equal finite values: the order of
    `jax.lax.top_k`."""
    s = np.array([[0.5, -np.inf, 2.0, -np.inf, 0.5, -np.inf, 2.0, 1.0]], np.float32)
    for k in (3, 6, 8):
        want = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1])
        np.testing.assert_array_equal(top_k_indices(torch.from_numpy(s), k).numpy(), want)


# --------------------------------------------------------------- kmeans ----


@pytest.mark.parametrize("case", ["plain", "active_mask", "init_centers"])
def test_kmeans_matches_jax(case):
    """Labels equal, centers <= 1e-5 (f32 sums in another order)."""
    x = blobs(seed=1)
    key = jax.random.PRNGKey(2)
    kw_j, kw_t = {}, {}
    if case == "active_mask":
        act = np.array([True, True, True, False])
        mask = np.arange(len(x)) < 90
        kw_j = dict(active=jnp.asarray(act), mask=jnp.asarray(mask))
        kw_t = dict(active=torch.from_numpy(act), mask=torch.from_numpy(mask))
    elif case == "init_centers":
        init = x[[0, 30, 60, 90]] + 0.5
        kw_j, kw_t = dict(init_centers=jnp.asarray(init)), dict(init_centers=torch.from_numpy(init))
    jl, jc = jkmeans(jnp.asarray(x), 4, key, **kw_j)
    tl, tc = tkmeans(torch.from_numpy(x), 4, JaxRng(key), **kw_t)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


def test_kmeans_batched_matches_jax_vmap():
    """A [C, n, d] batch with one stream per parent = JAX's vmap."""
    x = np.stack([blobs(seed=s) for s in (3, 4, 5)])
    mask = np.stack([np.arange(120) < m for m in (120, 60, 3)])  # last: 3 < k members
    act = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool)
    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    jl, jc = jax.vmap(lambda xx, kk, a, m: jkmeans(xx, 4, kk, active=a, mask=m))(
        jnp.asarray(x), keys, jnp.asarray(act), jnp.asarray(mask))
    tl, tc = tkmeans(torch.from_numpy(x), 4, [JaxRng(k) for k in keys],
                     active=torch.from_numpy(act), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


def test_kmeans_parent_smaller_than_k_takes_jax_init():
    """A parent with fewer members than k: its init takes -inf-scored
    non-members in index order, as `jax.lax.top_k` does (the order
    decides which points seed the spare centers)."""
    x = blobs(seed=7)
    mask = np.zeros(len(x), bool)
    mask[[5, 70]] = True
    key = jax.random.PRNGKey(8)
    jl, jc = jkmeans(jnp.asarray(x), 4, key, mask=jnp.asarray(mask), iters=3)
    tl, tc = tkmeans(torch.from_numpy(x), 4, JaxRng(key), mask=torch.from_numpy(mask), iters=3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


# ----------------------------------------------------------------- ncut ----


def _same_up_to_sign(got, want, rows, atol):
    sign = np.sign((got[rows] * want[rows]).sum(0))
    np.testing.assert_allclose(got[rows] * sign, want[rows], atol=atol, rtol=0)


@pytest.mark.parametrize("eig_method", ["eigh", "subspace"])
@pytest.mark.parametrize("distance", ["rbf", "cosine"])
def test_ncut_matches_jax(distance, eig_method):
    """With a member mask: eigenvalues <= 1e-4, eigenvectors (member rows)
    up to sign <= 1e-3.  Both `matmul_dtype`s: f32 with eigh, bf16 inputs
    (exact f32 products) with subspace."""
    x = blobs(seed=9)
    mask = np.arange(len(x)) < 90
    key = jax.random.PRNGKey(1)
    mm = "float32" if eig_method == "eigh" else "bfloat16"
    jv, jl = jncut(jnp.asarray(x), 4, key, num_sample=64, distance=distance,
                   mask=jnp.asarray(mask), eig_method=eig_method, matmul_dtype=mm)
    tv, tl = tncut(torch.from_numpy(x), 4, JaxRng(key), num_sample=64, distance=distance,
                   mask=torch.from_numpy(mask), eig_method=eig_method, matmul_dtype=mm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _same_up_to_sign(tv.numpy(), np.asarray(jv), mask, 1e-3)


def test_ncut_parent_smaller_than_sample_matches_jax():
    """5 members, 16 samples: the sample takes 11 non-members (their
    affinities are zeroed, so their order is harmless); eigenvalues and
    member rows still equal JAX's."""
    x = blobs(seed=10)
    mask = np.zeros(len(x), bool)
    mask[[1, 2, 40, 41, 100]] = True
    key = jax.random.PRNGKey(4)
    jv, jl = jncut(jnp.asarray(x), 4, key, num_sample=16, mask=jnp.asarray(mask),
                   eig_method="subspace")
    tv, tl = tncut(torch.from_numpy(x), 4, JaxRng(key), num_sample=16,
                   mask=torch.from_numpy(mask), eig_method="subspace")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _same_up_to_sign(tv.numpy(), np.asarray(jv), mask, 1e-3)


def test_ncut_shared_and_kway_ncut_raise():
    """`ncut_shared` (held against JAX in
    tests/test_torch_multistate_train.py) gives an embedding per parent.
    (`kway_ncut` no longer raises: tests/test_torch_fps_axis.py holds it
    against JAX.)"""
    member = torch.from_numpy(np.arange(120) < 60)[None].repeat(2, 1)
    member[1] = ~member[1]
    vecs, vals = tncut_mod.ncut_shared(torch.from_numpy(blobs()), 4, Rng(0), member,
                                       num_sample=32, anchors_per_parent=8)
    assert vecs.shape == (2, 120, 4) and vals.shape == (2, 4)
    assert torch.isfinite(vecs).all() and torch.isfinite(vals).all()


# ------------------------------------------------------ spectral module ----


def _scenes(b=2, n=40, d=24, k=3, seed=0):
    """[B, N, D] tokens, each near one of k centers (std 0.3 around centers
    of std 3), and [B, N] parent ids: the first event (all in parent 0) or
    two parents split by the token's center."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 3.0
    lab = rng.integers(0, k, (b, n))
    x = centers[lab] + 0.3 * rng.standard_normal((b, n, d))
    return x.astype(np.float32), (lab > 0).astype(np.int32)


@pytest.mark.parametrize("pool_batch", [True, False])
@pytest.mark.parametrize("parents,max_parents,late", [
    ("one", 1, 0), ("one", None, 0), ("two", 2, 8), ("two", 4, 0)])
def test_spectral_cluster_matches_jax(pool_batch, parents, max_parents, late):
    """Child indices and n_children equal JAX's, pooled and per image, with
    a static parent bound and a late sample budget (8 < the members of a
    parent, 16 > them where late = 0)."""
    x, parent2 = _scenes(seed=11)
    parent = np.zeros_like(parent2) if parents == "one" else parent2
    kw = dict(ncut_dim=4, num_sample=16, max_clusters=6, pool_batch=pool_batch,
              late_num_sample=late)
    jcfg, tcfg = jcl.SpectralClusteringConfig(**kw), tcl.SpectralClusteringConfig(**kw)
    key = jax.random.PRNGKey(12)
    ji, jn = jcl.spectral_cluster(jcfg, jnp.asarray(parent), jnp.asarray(x), key,
                                  max_parents=max_parents)
    ti, tn = tcl.spectral_cluster(tcfg, torch.from_numpy(parent).long(),
                                  torch.from_numpy(x), JaxRng(key), max_parents=max_parents)
    assert int(np.asarray(jn).sum()) >= 2  # a live split
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_clustering_configs_match_jax():
    for name in ("ClusteringConfig", "SpectralClusteringConfig",
                 "FPSClusteringConfig", "AxisAlignClusteringConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcl, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcl, name))]
        assert jf == tf, name


@pytest.mark.parametrize("max_parents", [1, 2, 3, 16])
def test_max_children_bound_matches_jax(max_parents):
    for name in ("SpectralClusteringConfig", "FPSClusteringConfig",
                 "AxisAlignClusteringConfig"):
        assert (tcl.max_children_bound(getattr(tcl, name)(), max_parents)
                == jcl.max_children_bound(getattr(jcl, name)(), max_parents))


@pytest.mark.parametrize("cfg", [pytest.param(tcl.ClusteringConfig(), id="cfg2")])
def test_unported_clustering_raises(cfg):
    """A `model_type` of no clustering raises.  (FPS and axis-align run:
    tests/test_torch_fps_axis.py.)"""
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="model_type"):
        tcl.cluster(cfg, torch.zeros(1, 8, dtype=torch.long), x, Rng(0))
