"""PyTorch port, the multistate leftovers against the JAX package (CPU):
`pca_lowrank`, both farthest-point samplers, `kway_ncut`, the FPS and
axis-align clusterings (pooled and per image, and inside
`MultiStateViTEncoderModel`), and the least-squares TX compression
`compress_tokens_with_cluster_indices`.

Randomness: the port draws JAX's numbers through `JaxRng`.  Eigenvector
signs: LAPACK behind `torch.linalg.eigh` and behind `jnp.linalg.eigh` pick
opposite signs for some columns (about one in six of random symmetric
matrices' columns on this CPU build); the FPS clustering sorts by a PCA
coordinate and axis-align takes an argmax over NCut axes, so both depend
on them.  Where a test holds those clusterings to JAX's partition, it
hands the port JAX's eigensolver (`jax_eigh`), as `JaxRng` hands it JAX's
draws; `pca_lowrank` itself is held to JAX up to column sign."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import clustering as jcl
from msvit_tpu.models import multistate as jms
from msvit_tpu.models.multistate.model import (
    compress_tokens_with_cluster_indices as j_compress)
from msvit_tpu.ops import fps as jfps
from msvit_tpu.ops.linalg import pca_lowrank as j_pca
from msvit_tpu.ops.ncut import kway_ncut as j_kway
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import multistate_params_from_jax
from msvit_tpu_torch.models import clustering as tcl
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.models.multistate.model import compress_tokens_with_cluster_indices
from msvit_tpu_torch.ops import fps as tfps
from msvit_tpu_torch.ops.linalg import pca_lowrank
from msvit_tpu_torch.ops.ncut import kway_ncut
from msvit_tpu_torch.settings import parity_policy as t_parity
from test_torch_clustering import JaxRng, blobs


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def jax_eigh(monkeypatch):
    """`torch.linalg.eigh` answered by `jnp.linalg.eigh` (the port then sees
    JAX's eigenvector signs)."""
    def eigh(a):
        w, v = jnp.linalg.eigh(jnp.asarray(a.detach().cpu().numpy()))
        return (torch.from_numpy(np.array(w)).to(a.device),
                torch.from_numpy(np.array(v)).to(a.device))
    monkeypatch.setattr(torch.linalg, "eigh", eigh)


# ------------------------------------------------------------------ PCA ----


@pytest.mark.parametrize("n,d,q", [(60, 8, 4), (12, 40, 5)], ids=["tall", "wide"])
def test_pca_lowrank_matches_jax_up_to_sign(n, d, q):
    """U, S, V within 1e-5 of JAX's (f32), U and V up to a sign per column;
    both branches (the d x d and the n x n Gram matrix)."""
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    x[:, 0] *= 4.0  # distinct singular values
    ju, js, jv = (np.asarray(t) for t in j_pca(jnp.asarray(x), q))
    tu, ts, tv = (t.numpy() for t in pca_lowrank(torch.from_numpy(x), q))
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=1e-5)
    sign = np.sign((tu * ju).sum(0))
    assert (np.abs(sign) == 1).all()
    np.testing.assert_allclose(tu * sign, ju, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv * sign, jv, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ FPS ----


@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sampling_matches_jax(keyed, masked):
    """Exact FPS: the same k indices as JAX, from JAX's Gumbel draws (or
    index 0 first), a mask never taken."""
    x = blobs(k=5, n_per=12, d=6, seed=3)
    mask = np.random.default_rng(1).random(60) < 0.7 if masked else None
    key = jax.random.PRNGKey(4)
    want = np.asarray(jfps.farthest_point_sampling(
        jnp.asarray(x), 12, key=key if keyed else None,
        mask=None if mask is None else jnp.asarray(mask)))
    got = tfps.farthest_point_sampling(
        torch.from_numpy(x), 12, key=JaxRng(key) if keyed else None,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    if masked:
        assert mask[got.numpy()].all()


@pytest.mark.parametrize("k,groups,n", [(16, 8, 61), (12, 8, 64), (6, 8, 50)],
                         ids=["g8-wrap", "g4", "g2"])
@pytest.mark.parametrize("keyed", [True, False])
def test_farthest_point_sampling_blocked_matches_jax(k, groups, n, keyed):
    """Blocked FPS, G chains as one batched loop: the same indices as
    JAX's vmapped chains (G halving until it divides k; n not a multiple
    of G wrap-pads), with a mask."""
    x = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    mask = np.random.default_rng(n + 1).random(n) < 0.85
    key = jax.random.PRNGKey(k)
    want = np.asarray(jfps.farthest_point_sampling_blocked(
        jnp.asarray(x), k, key=key if keyed else None, mask=jnp.asarray(mask),
        groups=groups))
    got = tfps.farthest_point_sampling_blocked(
        torch.from_numpy(x), k, key=JaxRng(key) if keyed else None,
        mask=torch.from_numpy(mask), groups=groups)
    assert got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ kway_ncut ----


def test_kway_ncut_matches_jax():
    """Yu-Shi discretisation of a 5-cluster spectral embedding: the same
    one-hot, the rotation within 1e-4."""
    rng = np.random.default_rng(2)
    basis = np.linalg.qr(rng.standard_normal((5, 5)))[0]
    x = (basis[rng.integers(0, 5, 200)] + 0.2 * rng.standard_normal((200, 5))).astype(np.float32)
    joh, jr = j_kway(jnp.asarray(x))
    toh, tr = kway_ncut(torch.from_numpy(x))
    assert (np.asarray(joh).sum(0) > 0).all()  # every cluster holds rows
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


# ------------------------------------------------- clustering module ----


def _scenes(b=2, n=48, d=24, k=4, seed=0):
    """[B, N, D] tokens near k centers, [B, N] parent ids (two parents)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 3.0
    lab = rng.integers(0, k, (b, n))
    x = centers[lab] + 0.3 * rng.standard_normal((b, n, d))
    return x.astype(np.float32), (lab > 1).astype(np.int32)


# FPS on the dense `eigh` NCut: the subspace iteration's Ritz vectors come
# from an [2k, 2k] eigh of a basis whose unconverged directions carry each
# package's rounding, so even JAX's solver may flip a column there
_FPS = dict(ncut_dim=4, num_sample=32, max_clusters=6, fps_dim=4, fps_sample1=16,
            fps_sample2=4, fps_supersample2=8, eig_method="eigh")
_AXIS = dict(ncut_dim=4, num_sample=32, max_clusters=6)


@pytest.mark.parametrize("pool_batch", [True, False])
@pytest.mark.parametrize("kind", ["fps", "axis"])
def test_clustering_matches_jax(jax_eigh, kind, pool_batch):
    """`fps_cluster` and `axis_align_cluster`, pooled and per image: child
    ids and n_children (credited to the parent holding most of each
    child's tokens) equal JAX's, from JAX's draws and eigensolver."""
    x, parent = _scenes(seed=7)
    name, kw = (("FPSClusteringConfig", _FPS) if kind == "fps"
                else ("AxisAlignClusteringConfig", _AXIS))
    jcfg = getattr(jcl, name)(pool_batch=pool_batch, **kw)
    tcfg = getattr(tcl, name)(pool_batch=pool_batch, **kw)
    key = jax.random.PRNGKey(5)
    ji, jn = jax.jit(lambda p, t, k: jcl.cluster(jcfg, p, t, k))(
        jnp.asarray(parent), jnp.asarray(x), key)
    ti, tn = tcl.cluster(tcfg, torch.from_numpy(parent).long(), torch.from_numpy(x),
                         JaxRng(key))
    assert len(np.unique(np.asarray(ji))) >= 2  # a live split
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def _ms_pixels(b=2, img=64, p=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((k, p, p, 3)) * 3.0
    g = img // p
    x = protos[rng.integers(0, k, (b, g, g))] + 0.1 * rng.standard_normal((b, g, g, p, p, 3))
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, img, img, 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["fps", "axis"])
def test_multistate_model_with_clustering_matches_jax(jax_eigh, kind):
    """`MultiStateViTEncoderModel` with FPS or axis-align clustering (events
    at layers 1 and 2, 64 tokens an image, pooled): the partitions equal
    JAX's; hidden states, TX tokens and RX -> TX attentions of the valid
    clusters within 1e-3 (f32)."""
    name, kw = (("FPSClusteringConfig", _FPS) if kind == "fps"
                else ("AxisAlignClusteringConfig", _AXIS))
    kw = {**kw, "max_clusters": 4}
    base = dict(hidden_size=64, num_attention_heads=4, num_hidden_layers=3, image_size=64,
                patch_size=8, attn_implementation="xla", pregeneration_period=1,
                generation_period=1)
    jcfg = jms.MultiStateViTConfig(policy=j_parity(), clustering=getattr(jcl, name)(**kw),
                                   **base)
    tcfg = tms.MultiStateViTConfig(policy=t_parity(), clustering=getattr(tcl, name)(**kw),
                                   **base)
    pix = _ms_pixels(seed=3)
    key = jax.random.PRNGKey(3)
    model = jms.MultiStateViTEncoderModel(jcfg)
    # initialised without clustering events (the same params, a cheaper init)
    variables = jax.jit(jms.MultiStateViTEncoderModel(
        dataclasses.replace(jcfg, pregeneration_period=99)).init)(
            {"params": key, "clustering": key}, jnp.asarray(pix))
    tmodel = tms.MultiStateViTEncoderModel(tcfg)
    tmodel.load_state_dict(multistate_params_from_jax(variables, tcfg), strict=True)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda v, p, k: model.apply(v, p, rng=k, output_cluster_indices=True))(
        variables, jnp.asarray(pix), key)
    with torch.inference_mode():
        got = tmodel.eval()(torch.from_numpy(pix), rng=JaxRng(key),
                            output_cluster_indices=True)
    nc = int(np.asarray(want["num_clusters"]))
    assert nc >= 2  # live splits
    assert int(got["num_clusters"]) == nc
    for a, b in zip(got["cluster_indices"], want["cluster_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    np.testing.assert_allclose(_np(got["last_hidden_state"]), _np(want["last_hidden_state"]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(got["cluster_tokens"][:, :nc]),
                               _np(want["cluster_tokens"][:, :nc]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        _np(got["receiver_to_transmitter_attentions"][:, :, :nc, :nc]),
        _np(want["receiver_to_transmitter_attentions"][:, :, :nc, :nc]), atol=1e-3, rtol=0)


def test_configs_build_with_fps_and_axis():
    """Both clusterings pass `check_supported` and build the model; an
    unknown `model_type` still raises."""
    base = dict(hidden_size=32, num_attention_heads=2, num_hidden_layers=1, image_size=32,
                patch_size=16)
    for c in (tcl.FPSClusteringConfig(), tcl.AxisAlignClusteringConfig()):
        tms.MultiStateViTEncoderModel(tms.MultiStateViTConfig(clustering=c, **base))
    with pytest.raises(ValueError, match="model_type"):
        tms.MultiStateViTEncoderModel(tms.MultiStateViTConfig(
            clustering=dataclasses.replace(tcl.FPSClusteringConfig(), model_type="hdb"),
            **base))


# -------------------------------------------------------- compression ----


def test_compress_tokens_matches_jax():
    """The least-squares TX tokens (a rank-deficient design: the bias
    absorbers) equal JAX's minimum-norm solution within 1e-4 (f32)."""
    rng = np.random.default_rng(0)
    b, h, n, dh, d, c = 2, 2, 6, 4, 8, 3
    q = rng.standard_normal((b, h, n, dh)).astype(np.float32)
    wk = rng.standard_normal((d, h, dh)).astype(np.float32) * 0.5
    bk = rng.standard_normal((h, dh)).astype(np.float32) * 0.1
    logits = rng.standard_normal((b, h, n, n)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ci = np.stack([rng.permutation(np.arange(n) % c) for _ in range(b)]).astype(np.int32)
    want = np.asarray(j_compress(*(jnp.asarray(t) for t in (q, wk, bk, probs, ci)), c, dh))
    got = compress_tokens_with_cluster_indices(
        *(torch.from_numpy(t) for t in (q, wk, bk, probs)), torch.from_numpy(ci).long(), c, dh)
    assert got.shape == want.shape == (b, c, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
