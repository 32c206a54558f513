"""PyTorch port, multistate training slice, against the JAX package (CPU):

* the plain versions of K5-lse (`fused_attention_lse`) and K6
  (`flash_attention_bwd`) against the JAX Pallas kernels in interpret mode
  (`_fused_forward(with_lse=True)`, `flash_attention_bwd`);
* `FusedAttentionFunction` (K5-lse forward, K6 backward) against
  `jax.grad` through JAX's `fused_attention`, and `gradcheck` in float64;
* the fully masked row under training, both packages' values pinned;
* `ncut_shared` and `cluster(shared_anchors=True)` with JAX's draws
  (`JaxRng`).

The whole classifier (`MultiStateViTForImageClassification`), its
`Trainer` steps and the example are in
`tests/test_torch_multistate_finetune.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msvit_tpu.ops.fused_attention as jfused
from msvit_tpu.models import clustering as jcl
from msvit_tpu.ops.flash_attention import flash_attention_bwd as j_flash_bwd
from msvit_tpu.ops.ncut import ncut_shared as jncut_shared
import msvit_tpu_torch.ops.fused_attention as tfused
from msvit_tpu_torch.models import clustering as tcl
from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
from msvit_tpu_torch.ops.ncut import ncut_shared
from test_torch_clustering import JaxRng, _same_up_to_sign, _scenes, blobs

B = 2
# (Nq, Nk, heads, dh)
_SHAPES = {"square": (40, 40, 4, 64), "cross": (24, 72, 2, 16)}
_MASKS = [None, "bool_per_head", "bool_broadcast", "soft"]
# f32: summation order only.  bf16: both sides round p (K5-lse) or p and ds
# (K6) to bf16 before the products; f32 sums in another order can move a
# rounding by one bf16 step: 2e-2 of max(1, max |ref|), the K1 bar.
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(shape, seed):
    nq, nk, h, dh = _SHAPES[shape]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, h, nq, dh)).astype(np.float32),
            rng.standard_normal((B, h, nk, dh)).astype(np.float32),
            rng.standard_normal((B, h, nk, dh)).astype(np.float32))


def _mask(kind, shape, seed):
    """No fully masked row (that row is test_fully_masked_row_pinned's)."""
    nq, nk, h, _ = _SHAPES[shape]
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "soft":  # the multistate penalty on ~30% of the entries
        return np.where(rng.random((B, 1, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)
    m = rng.random((B, h if kind == "bool_per_head" else 1, nq, nk)) < 0.7
    m[..., 0] = True
    return m


def _close(got, want, dtype):
    want = _np(want)
    tol = _TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def jax_fwd():
    """JAX interpret-mode K5-lse (out, compact lse) per case."""
    cache = {}

    def get(shape, mask, dtype):
        key = (shape, mask, dtype)
        if key not in cache:
            q, k, v = _inputs(shape, 1)
            m = _mask(mask, shape, 2)
            jdt = getattr(jnp, dtype)
            nq = q.shape[2]
            out, lse = jfused._fused_forward(
                *(jnp.asarray(t, jdt) for t in (q, k, v)),
                None if m is None else jnp.asarray(m),
                scale=q.shape[-1] ** -0.5, mask_value=DEFAULT_MASK_VALUE, with_lse=True)
            cache[key] = (out, lse[:, :, :nq, 0])
        return cache[key]

    return get


def _torch(xs, dtype):
    return [None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))
            for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", _MASKS)
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_k5_lse_plain_matches_jax(jax_fwd, shape, mask, dtype):
    """K5-lse plain vs `_fused_forward(with_lse=True)` (interpret mode):
    out within the dtype's bar, the compact lse (lane 0 of JAX's
    lane-replicated layout) within 1e-5 of max(1, |lse|).  The wrapper on
    CPU tensors runs the plain version (no launch)."""
    q, k, v = _torch(_inputs(shape, 1), dtype)
    m = _mask(mask, shape, 2)
    before = tfused.fused_attention_lse.launches
    out, lse = tfused.fused_attention_lse(q, k, v, mask=None if m is None else torch.from_numpy(m))
    assert tfused.fused_attention_lse.launches == before
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    want_out, want_lse = jax_fwd(shape, mask, dtype)
    _close(out, want_out, dtype)
    np.testing.assert_allclose(_np(lse), _np(want_lse),
                               atol=1e-5 * max(1.0, float(np.abs(_np(want_lse)).max())), rtol=0)


# (Nq, Nk, heads, dh, mask): Nq and Nk one short of and one past a 64-row
# tile and two tiles plus one, Nq != Nk both ways; dh 16, 64 and 128
_TILE_EDGES = [(63, 65, 2, 16, "bool_per_head"), (65, 129, 2, 64, "soft"),
               (129, 63, 2, 128, "bool_broadcast"), (129, 129, 2, 64, "soft")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,h,dh,mask", _TILE_EDGES)
def test_k5_lse_plain_matches_jax_at_tile_edges(nq, nk, h, dh, mask, dtype):
    """The contract the card's bf16 tensor-core K5-lse is held to, where
    its 64-row tiles have edges: the plain version vs `_fused_forward(
    with_lse=True)` (interpret mode), out within the dtype's bar (f32 1e-5,
    bf16 2e-2, of max(1, max |JAX|)), the compact lse within 1e-5 of
    max(1, |lse|).  No row is fully masked."""
    rng = np.random.default_rng(nq * 5 + nk + dh)
    q, k, v = (rng.standard_normal((B, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))
    if mask == "soft":
        m = np.where(rng.random((B, 1, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)
    else:
        m = rng.random((B, h if mask == "bool_per_head" else 1, nq, nk)) < 0.7
        m[..., 0] = True
    jdt = getattr(jnp, dtype)
    want_out, want_lse = jfused._fused_forward(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(m), scale=dh**-0.5,
        mask_value=DEFAULT_MASK_VALUE, with_lse=True)
    tq, tk, tv = _torch((q, k, v), dtype)
    out, lse = tfused.fused_attention_lse(tq, tk, tv, mask=torch.from_numpy(m))
    assert out.dtype == tq.dtype and out.shape == (B, h, nq, dh)
    _close(out, want_out, dtype)
    want_lse = _np(want_lse)[:, :, :nq, 0]
    np.testing.assert_allclose(_np(lse), want_lse,
                               atol=1e-5 * max(1.0, float(np.abs(want_lse).max())), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", _MASKS)
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_k6_plain_matches_jax(jax_fwd, shape, mask, dtype):
    """K6 plain vs JAX's `flash_attention_bwd` (interpret mode) on the same
    residuals (JAX's out and compact lse) and cotangent: dq, dk, dv within
    the dtype's bar.  No launch on CPU tensors."""
    q, k, v = _inputs(shape, 1)
    m = _mask(mask, shape, 2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    out, lse = jax_fwd(shape, mask, dtype)
    jdt = getattr(jnp, dtype)
    want = j_flash_bwd(*(jnp.asarray(t, jdt) for t in (q, k, v)), out, jnp.asarray(g),
                       lse, None if m is None else jnp.asarray(m),
                       scale=q.shape[-1] ** -0.5, mask_value=DEFAULT_MASK_VALUE)
    tq, tk, tv, tg = _torch((q, k, v, g), dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, torch.from_numpy(_np(out)).to(tq.dtype),
                              tg, torch.from_numpy(_np(lse)),
                              None if m is None else torch.from_numpy(m))
    assert flash_attention_bwd.launches == before
    for a, b in zip(got, want):
        assert a.dtype == tq.dtype and a.shape == b.shape
        _close(a, b, dtype)


def test_k6_plain_rounds_p_after_ds_not_before():
    """The trap: K6 keeps p = exp(s - lse) in f32 into ds = p (dp - delta)
    and rounds p only as dV's operand; K2 rounds p first.  In bf16 the two
    orders give different dq, and K6's plain version takes JAX's."""
    q, k, v = _inputs("square", 4)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tg = _torch((q, k, v, g), "bfloat16")
    out, lse = tfused.fused_attention_lse_plain(tq, tk, tv)
    dq, _, _ = flash_attention_bwd_plain(tq, tk, tv, out, tg, lse)
    # K2's order on the same inputs: pb = round(p), ds = round(pb (dp - delta))
    s = torch.matmul(tq.float(), tk.float().mT) / 8.0
    pb = torch.exp(s - lse[..., None]).bfloat16().float()
    dp = torch.matmul(tg.float(), tv.float().mT)
    delta = (tg.float() * out.float()).sum(-1, keepdim=True)
    dq_k2 = (torch.matmul((pb * (dp - delta)).bfloat16().float(), tk.float()) / 8.0).bfloat16()
    assert not torch.equal(dq, dq_k2)
    want = j_flash_bwd(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                       jnp.asarray(_np(out), jnp.bfloat16), jnp.asarray(g), jnp.asarray(_np(lse)),
                       None, scale=0.125, mask_value=DEFAULT_MASK_VALUE)[0]
    err = np.abs(_np(dq) - _np(want)).max()
    assert err <= np.abs(_np(dq_k2) - _np(want)).max()
    assert err <= 2e-2 * max(1.0, float(np.abs(_np(want)).max()))


# ------------------------------------------------- FusedAttentionFunction ----


def _jax_value_and_grads(q, k, v, m, w, dtype):
    jdt = getattr(jnp, dtype)

    def f(q, k, v):
        out = jfused.fused_attention(q, k, v, mask=None if m is None else jnp.asarray(m))
        return jnp.sum(out.astype(jnp.float32) * w)

    return jax.value_and_grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t, jdt) for t in (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask", [("square", "soft"), ("cross", "bool_per_head")])
def test_fused_function_grads_match_jax(shape, mask, dtype):
    """Autograd through the port's `fused_attention` (FusedAttentionFunction:
    K5-lse and K6 plain on the CPU, no launch) against `jax.value_and_grad`
    through JAX's `fused_attention` (its custom VJP: K5-lse and K6 in
    interpret mode): value rtol 1e-5 (f32) / 1e-2 (bf16); dq, dk, dv within
    the dtype's bar."""
    q, k, v = _inputs(shape, 6)
    m = _mask(mask, shape, 7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    jv, jg = _jax_value_and_grads(q, k, v, m, w, dtype)
    ts = [t.requires_grad_() for t in _torch((q, k, v), dtype)]
    n = (tfused.fused_attention.launches, tfused.fused_attention_lse.launches,
         flash_attention_bwd.launches)
    out = tfused.fused_attention(*ts, mask=None if m is None else torch.from_numpy(m))
    val = (out.float() * torch.from_numpy(w)).sum()
    val.backward()
    assert (tfused.fused_attention.launches, tfused.fused_attention_lse.launches,
            flash_attention_bwd.launches) == n
    assert type(out.grad_fn).__name__ == "FusedAttentionFunctionBackward"
    np.testing.assert_allclose(float(val.detach()), float(jv), rtol=1e-5 if dtype == "float32" else 1e-2)
    for t, want in zip(ts, jg):
        assert t.grad.dtype == t.dtype
        _close(t.grad, want, dtype)


def test_fused_function_gradcheck_float64():
    """torch.autograd.gradcheck of FusedAttentionFunction (plain versions in
    float64) on tiny shapes: Nq != Nk, an additive mask per head, every
    input differentiated."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 2, 4, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    m = torch.from_numpy(np.where(rng.random((1, 2, 4, 6)) < 0.3, -3.0, 0.0))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfused.fused_attention(q, k, v, mask=m), (q, k, v),
        eps=1e-6, atol=1e-5)


def test_fully_masked_row_pinned():
    """A bool row with no True, under training.  Forward: JAX's K5-lse gives
    sum(V) / 128 (the keys padded to 128 counted), the port mean(V) over
    the 40 real keys (test_torch_multistate::test_fully_masked_row_deviation).
    lse = mask_value + log(Nk) rounds to mask_value in f32, so the backward's
    p = exp(s - lse) is 1 for every key on both sides: dv equal.  delta =
    sum(g * o) differs with o, so the port's dq on the row is JAX's plus
    (delta_jax - delta_port) sum_j k_j * scale and every key's dk JAX's
    plus (delta_jax - delta_port) q_i * scale; all else agrees (f32, 1e-4
    of the largest |grad|)."""
    q, k, v = _inputs("square", 10)
    h, dh = q.shape[1], q.shape[3]
    m = np.random.default_rng(11).random((B, h, 40, 40)) < 0.7
    m[..., 0] = True
    bi, hi, ri = 1, 2, 5
    m[bi, hi, ri, :] = False
    w = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    jv, jg = _jax_value_and_grads(q, k, v, m, w, "float32")
    ts = [t.requires_grad_() for t in _torch((q, k, v), "float32")]
    out = tfused.fused_attention(*ts, mask=torch.from_numpy(m))
    (out * torch.from_numpy(w)).sum().backward()
    jout = _np(jfused.fused_attention(*(jnp.asarray(t) for t in (q, k, v)), mask=jnp.asarray(m)))
    np.testing.assert_allclose(jout[bi, hi, ri], v[bi, hi].sum(0) / 128, atol=1e-5)
    np.testing.assert_allclose(_np(out)[bi, hi, ri], v[bi, hi].mean(0), atol=1e-5)
    g_row = w[bi, hi, ri]
    d_delta = float(g_row @ jout[bi, hi, ri] - g_row @ _np(out)[bi, hi, ri])
    scale = dh ** -0.5
    want_dq, want_dk = _np(jg[0]).copy(), _np(jg[1]).copy()
    want_dq[bi, hi, ri] += d_delta * k[bi, hi].sum(0) * scale
    want_dk[bi, hi] += d_delta * q[bi, hi, ri] * scale
    for got, want in ((ts[0].grad, want_dq), (ts[1].grad, want_dk), (ts[2].grad, jg[2])):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert abs(d_delta) > 1e-2  # the deviation is real, not a tie


# ------------------------------------------------------------ ncut_shared ----


@pytest.mark.parametrize("eig_method", ["subspace", "eigh"])
@pytest.mark.parametrize("distance", ["rbf", "cosine"])
def test_ncut_shared_matches_jax(distance, eig_method):
    """Three parents (one of 4 members, fewer than its anchor budget) and an
    empty slot, a pool of 64 and 24 anchors per parent: eigenvalues <= 1e-4,
    member rows of the eigenvectors up to sign <= 1e-3 (both matmul
    dtypes: f32 with eigh, bf16 inputs with subspace)."""
    x = blobs(seed=13)
    parent = np.repeat([0, 1, 2], [60, 56, 4])
    member = parent[None, :] == np.arange(4)[:, None]
    key = jax.random.PRNGKey(14)
    kw = dict(num_sample=64, anchors_per_parent=24, distance=distance,
              eig_method=eig_method, matmul_dtype="float32" if eig_method == "eigh" else "bfloat16")
    jv, jl = jncut_shared(jnp.asarray(x), 4, key, jnp.asarray(member), **kw)
    tv, tl = ncut_shared(torch.from_numpy(x), 4, JaxRng(key), torch.from_numpy(member), **kw)
    assert tv.shape == (4, 120, 4) and tl.shape == (4, 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for c in range(3):
        _same_up_to_sign(tv[c].numpy(), np.asarray(jv[c]), member[c], 1e-3)


@pytest.mark.parametrize("pool_batch", [True, False])
@pytest.mark.parametrize("parents,max_parents", [("one", 1), ("two", 4)])
def test_shared_anchor_cluster_matches_jax(pool_batch, parents, max_parents):
    """`cluster(shared_anchors=True)`: child indices and n_children equal
    JAX's, pooled and per image, one parent (the first event) and two."""
    x, parent2 = _scenes(seed=15)
    parent = np.zeros_like(parent2) if parents == "one" else parent2
    kw = dict(ncut_dim=4, num_sample=24, max_clusters=6, pool_batch=pool_batch,
              shared_anchors=True, anchors_per_parent=12)
    jcfg, tcfg = jcl.SpectralClusteringConfig(**kw), tcl.SpectralClusteringConfig(**kw)
    key = jax.random.PRNGKey(16)
    ji, jn = jcl.cluster(jcfg, jnp.asarray(parent), jnp.asarray(x), key,
                         max_parents=max_parents)
    ti, tn = tcl.cluster(tcfg, torch.from_numpy(parent).long(), torch.from_numpy(x),
                         JaxRng(key), max_parents=max_parents)
    assert int(np.asarray(jn).sum()) >= 2  # a live split
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_flash_forward_not_ported():
    """The CUDA kernel K7 has no CPU counterpart: on CPU tensors
    `flash_attention` runs its plain version (no launch), K5's function."""
    q, k, v = (torch.from_numpy(t) for t in _inputs("square", 1))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(got, tfused.fused_attention_plain(q, k, v), atol=0, rtol=0)
