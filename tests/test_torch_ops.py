"""PyTorch port, ops: each op of `msvit_tpu_torch.ops` against its JAX
counterpart on the same numpy inputs (CPU; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them).  On the CPU the
port's kernel wrappers take their plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.ops import gelu as jgelu
from msvit_tpu.ops import quant as jquant
from msvit_tpu.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu.ops.packed_attention import (
    _packed_backward as j_packed_backward,
    _packed_forward as j_packed_forward,
    packed_attention as j_packed,
    packed_attention_int8 as j_packed_int8,
)
from msvit_tpu_torch.ops import gelu as tgelu
from msvit_tpu_torch.ops import quant as tquant
from msvit_tpu_torch.ops.packed_attention import (
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_plain,
    packed_attention_int8,
    packed_attention_lse,
    packed_attention_lse_plain,
    packed_attention_plain,
)

B, N, D, H = 2, 37, 64, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, shape=(B, N, 3 * D), scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _mask(kind, seed, b=B, h=H, n=N):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        m = rng.random((b, 1, n, n)) < 0.7
        m |= np.eye(n, dtype=bool)[None, None]
        m[:, :, 0, :] = False  # one fully masked row: mean(V) on both
        return m
    if kind == "additive":
        return (-100.0 * (rng.random((b, h, n, n)) < 0.3)).astype(np.float32)
    return None


# ------------------------------------------------------------------ K1 ----

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_packed_attention_plain_matches_jax(dtype, mask_kind, scale):
    """K1 plain vs JAX `packed_attention` (interpret).  Tolerance: f32
    1e-5 max abs; bf16 2e-2 (the bar of tests/test_packed_attention.py)."""
    x = _qkv(0)
    m = _mask(mask_kind, 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_packed(jnp.asarray(x, jdt), H,
                    mask=None if m is None else jnp.asarray(m), scale=scale)
    before = packed_attention.launches
    got = packed_attention(torch.from_numpy(x).to(tdt), H,
                           mask=None if m is None else torch.from_numpy(m),
                           scale=scale)
    assert packed_attention.launches == before  # CPU: plain version
    assert got.dtype == tdt and got.shape == (B, N, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dtype], rtol=0)


def test_packed_attention_flattens_large_logits_like_jax():
    """The bounded-logit contract: logits past +-80 are clamped, not
    max-subtracted, on both sides (f32, 1e-5 of the value scale: v is
    scaled by 12 here)."""
    x = _qkv(2, scale=12.0)
    want = j_packed(jnp.asarray(x), H)
    got = packed_attention(torch.from_numpy(x), H)
    np.testing.assert_allclose(_np(got), _np(want), atol=12 * 1e-5, rtol=0)


def test_packed_attention_vitb_image_shape():
    """One image at ViT-B's shape [1, 197, 2304], 12 heads, bf16 (2e-2)."""
    x = _qkv(3, shape=(1, 197, 2304))
    want = j_packed(jnp.asarray(x, jnp.bfloat16), 12)
    got = packed_attention(torch.from_numpy(x).bfloat16(), 12)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)


def test_packed_attention_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU goes to a kernel or raises."""
    x = torch.empty((B, N, 3 * D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        packed_attention(x, H)
    with pytest.raises(ValueError, match="no kernel"):
        packed_attention_int8(x.to(torch.int8), torch.ones(3), H)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,dh", [(65, 8), (65, 24), (65, 40), (130, 40), (129, 128)])
def test_packed_attention_plain_matches_jax_at_tile_edges(dtype, masked, n, dh):
    """The contract the card's bf16 tensor-core K1 is held to, pinned with
    the JAX package as the answer where its tiling has its edges: N one past
    a 64-row tile (a partial third tile at 129 and 130), head sizes that the
    kernel zero-pads to 16, 32 and 64.  K1 plain vs JAX `_packed_forward`
    (interpret, the inference branch: p = exp(clip(s, +-80)) rounded to the
    compute dtype, the row sum of that p), 2 images, 2 heads, unmasked or a
    bool mask with a fully masked row (mean(V) on both).  Tolerance as
    above: f32 1e-5, bf16 2e-2."""
    h = 2
    x = _qkv(50 + n + dh, shape=(2, n, 3 * h * dh))
    m = _mask("bool", 51 + n, b=2, n=n) if masked else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sc = 1.0 / dh**0.5
    want = j_packed_forward(jnp.asarray(x, jdt), _j_mask(m), h, sc, DEFAULT_MASK_VALUE)
    got = packed_attention_plain(torch.from_numpy(x).to(tdt), h, mask=_t_mask(m))
    assert got.dtype == tdt and got.shape == (2, n, h * dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dtype], rtol=0)


# ------------------------------------------------ K1-lse, K2, autograd ----

_BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _close_scaled(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _j_mask(m):
    return None if m is None else jnp.asarray(m)


def _t_mask(m):
    return None if m is None else torch.from_numpy(m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_packed_attention_lse_plain_matches_jax(dtype, mask_kind, scale):
    """K1-lse plain vs JAX `_packed_forward(with_lse=True)` (interpret),
    out and lse.  Tolerance: f32 1e-5 max abs; bf16 2e-2 (out; lse is f32
    from f32 scores: 1e-4)."""
    x = _qkv(10)
    m = _mask(mask_kind, 11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sc = 1.0 / (D // H) ** 0.5 if scale is None else scale
    want_o, want_l = j_packed_forward(
        jnp.asarray(x, jdt), _j_mask(m), H, sc, DEFAULT_MASK_VALUE,
        with_lse=True)
    before = packed_attention_lse.launches
    got_o, got_l = packed_attention_lse(torch.from_numpy(x).to(tdt), H,
                                        mask=_t_mask(m), scale=scale)
    assert packed_attention_lse.launches == before  # CPU: plain version
    assert got_o.dtype == tdt and got_o.shape == (B, N, D)
    assert got_l.dtype == torch.float32 and got_l.shape == (B, H, N)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=_TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(got_l), _np(want_l),
                               atol=1e-4 if dtype == "bfloat16" else 1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_packed_attention_bwd_plain_matches_jax(dtype, mask_kind, scale):
    """K2 plain vs JAX `_packed_backward` (interpret) on the same
    residuals (JAX's own forward) and cotangent.  Tolerance: f32 1e-5,
    bf16 3e-2 (the bar of tests/test_packed_attention.py), each times
    max(1, max |dqkv|): at scale 1.0 the logits reach ~20 and dqkv ~10."""
    x = _qkv(12)
    m = _mask(mask_kind, 13)
    g = _qkv(14, shape=(B, N, D))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sc = 1.0 / (D // H) ** 0.5 if scale is None else scale
    jx, jm = jnp.asarray(x, jdt), _j_mask(m)
    out, lse = j_packed_forward(jx, jm, H, sc, DEFAULT_MASK_VALUE, with_lse=True)
    want = j_packed_backward(jx, jm, out, lse, jnp.asarray(g, jdt), H, sc,
                             DEFAULT_MASK_VALUE)
    before = packed_attention_bwd.launches
    got = packed_attention_bwd(
        torch.from_numpy(x).to(tdt), _t_mask(m),
        torch.tensor(_np(out)).to(tdt), torch.tensor(_np(lse)),
        torch.from_numpy(g).to(tdt), H, scale=scale)
    assert packed_attention_bwd.launches == before
    assert got.dtype == tdt and got.shape == (B, N, 3 * D)
    _close_scaled(got, want, _BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,dh", [(65, 8), (65, 24), (65, 40), (130, 40)])
def test_packed_training_plain_matches_jax_at_tile_edges(dtype, n, dh):
    """The contract the card's bf16 tensor-core kernels are held to, pinned
    with the JAX package as the answer where their tiling has its edges: N
    one past a 64-row tile (and a partial third tile at 130), head sizes
    that the kernels zero-pad to 16, 32 and 64.  K1-lse and K2 plain vs
    JAX `_packed_forward(with_lse=True)` and `_packed_backward`
    (interpret), 2 images, 2 heads, no mask.  Tolerances as the two tests
    above: out f32 1e-5, bf16 2e-2; lse f32 1e-5, bf16 1e-4 (rtol 1e-6);
    dqkv f32 1e-5, bf16 3e-2, each times max(1, max |dqkv|)."""
    h = 2
    x = _qkv(40 + n + dh, shape=(2, n, 3 * h * dh))
    g = _qkv(41 + n + dh, shape=(2, n, h * dh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sc = 1.0 / dh**0.5
    jx = jnp.asarray(x, jdt)
    want_o, want_l = j_packed_forward(jx, None, h, sc, DEFAULT_MASK_VALUE, with_lse=True)
    want_d = j_packed_backward(jx, None, want_o, want_l, jnp.asarray(g, jdt), h, sc,
                               DEFAULT_MASK_VALUE)
    tx = torch.from_numpy(x).to(tdt)
    got_o, got_l = packed_attention_lse_plain(tx, h)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=_TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(got_l), _np(want_l),
                               atol=1e-4 if dtype == "bfloat16" else 1e-5, rtol=1e-6)
    got_d = packed_attention_bwd_plain(
        tx, None, torch.tensor(_np(want_o)).to(tdt), torch.tensor(_np(want_l)),
        torch.from_numpy(g).to(tdt), h)
    assert got_d.dtype == tdt and got_d.shape == (2, n, 3 * h * dh)
    _close_scaled(got_d, want_d, _BWD_TOL[dtype])


def _jax_value_and_grad(x, m, g, dtype, scale=None):
    jdt = getattr(jnp, dtype)

    def f(q):
        o = j_packed(q, H, mask=_j_mask(m), scale=scale)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g))

    return jax.value_and_grad(f)(jnp.asarray(x, jdt))


def _torch_value_and_grad(x, m, g, dtype, scale=None):
    q = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    o = packed_attention(q, H, mask=_t_mask(m), scale=scale)
    val = (o.float() * torch.from_numpy(g)).sum()
    val.backward()
    return val.detach(), q.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
def test_packed_attention_grad_matches_jax(dtype, mask_kind):
    """Autograd through `packed_attention` (PackedAttentionFunction: K1-lse
    and K2 plain on the CPU) vs `jax.value_and_grad` of JAX's
    `packed_attention`.  Value rtol 1e-5 (f32) / 1e-2 (bf16); dqkv f32
    1e-5, bf16 3e-2, each times max(1, max |dqkv|)."""
    x = _qkv(15)
    m = _mask(mask_kind, 16)
    g = _qkv(17, shape=(B, N, D))
    jv, jg = _jax_value_and_grad(x, m, g, dtype)
    n1, n2 = packed_attention_lse.launches, packed_attention_bwd.launches
    tv, tg = _torch_value_and_grad(x, m, g, dtype)
    assert (packed_attention_lse.launches, packed_attention_bwd.launches) == (n1, n2)
    assert tg.dtype == getattr(torch, dtype) and tg.shape == (B, N, 3 * D)
    np.testing.assert_allclose(float(tv), float(jv),
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    _close_scaled(tg, jg, _BWD_TOL[dtype])


def test_packed_training_stable_at_large_logits_like_jax():
    """Port of tests/test_packed_attention.py::
    test_packed_training_stable_at_large_logits: q and k scaled by 12
    (logits far past the inference clamp), f32 [2, 37, 192], 4 heads.
    Under autograd the port must take JAX's max-subtracted `with_lse`
    softmax, not the shaved one: value rtol 1e-3, dqkv 3e-2."""
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2, 37, 192)).astype(np.float32)
    x[..., :128] *= 12.0  # q | k sections
    g = rng.standard_normal((2, 37, 64)).astype(np.float32)
    jv, jg = _jax_value_and_grad(x, None, g, "float32")
    tv, tg = _torch_value_and_grad(x, None, g, "float32")
    assert np.isfinite(_np(tg)).all()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-3)
    np.testing.assert_allclose(_np(tg), _np(jg), atol=3e-2, rtol=0)


def test_packed_attention_gradcheck_float64():
    """torch.autograd.gradcheck of PackedAttentionFunction (plain versions
    in float64) on a tiny shape with a bool mask and a fully masked row."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((1, 5, 24))).requires_grad_()
    m = torch.from_numpy(rng.random((1, 1, 5, 5)) < 0.7)
    m[..., 1, :] = True
    assert torch.autograd.gradcheck(
        lambda q: packed_attention(q, 2, mask=m), (x,), eps=1e-6, atol=1e-5)


def test_packed_attention_inference_path_unchanged():
    """Without autograd the dispatch stays on K1 (shaved softmax), even
    for a tensor that requires grad."""
    x = torch.from_numpy(_qkv(20, scale=12.0)).requires_grad_()
    with torch.no_grad():
        got = packed_attention(x, H)
    np.testing.assert_array_equal(_np(got), _np(packed_attention_plain(x.detach(), H)))


# ------------------------------------------------------------------ K3 ----


def _int8_inputs(seed):
    x = _qkv(seed, scale=0.5)
    sec = np.abs(x.reshape(-1, 3, D)).max(axis=(0, 2)) / 127.0
    q = np.clip(np.round(x / np.repeat(sec, D)), -127, 127).astype(np.int8)
    return q, sec.astype(np.float32)


def test_packed_attention_int8_bf16_out_matches_jax():
    """K3 plain vs JAX `packed_attention_int8`, bf16 out: rtol 1e-2 with
    atol 2e-3 for entries near zero."""
    q, sec = _int8_inputs(4)
    want = j_packed_int8(jnp.asarray(q), jnp.asarray(sec), H)
    got = packed_attention_int8(torch.from_numpy(q), torch.from_numpy(sec), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-3)


def test_packed_attention_int8_int8_out_matches_jax():
    """K3 int8 out: |delta| <= 1 everywhere, >= 99% of entries equal."""
    q, sec = _int8_inputs(5)
    ref = _np(j_packed_int8(jnp.asarray(q), jnp.asarray(sec), H))
    inv = np.float32(127.0 / np.abs(ref).max())
    want = np.asarray(j_packed_int8(jnp.asarray(q), jnp.asarray(sec), H,
                                    out_inv_scale=inv, int8_out=True))
    got = packed_attention_int8(torch.from_numpy(q), torch.from_numpy(sec),
                                H, out_inv_scale=torch.tensor(inv),
                                int8_out=True)
    assert got.dtype == torch.int8
    delta = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert delta.max() <= 1
    assert (delta == 0).mean() >= 0.99


def _int8_close(got, want, int8_out):
    """int8 out: |delta| <= 1 step with >= 99% equal (an exp within an ulp
    of an integer truncates one step apart in the two frameworks); bf16
    out: 2% of the output's range (one probability step moves o by
    s_v / l)."""
    got, want = _np(got), _np(want)
    if int8_out:
        delta = np.abs(got - want)
        assert delta.max() <= 1 and (delta == 0).mean() >= 0.99
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("int8_out", [False, True])
@pytest.mark.parametrize("n", [31, 33, 65, 129])
@pytest.mark.parametrize("dh", [16, 40, 64, 128])
def test_packed_attention_int8_plain_matches_jax_at_tile_edges(dh, n, int8_out):
    """The contract the card's int8 tensor-core K3 is held to, pinned with
    the JAX package as the answer where the kernel's tiles have edges: N
    one short of and one past its 32-key k-steps and 64-key tiles, head
    sizes it pads to its 32-byte k-depth (16, 40).  K3 plain vs JAX
    `packed_attention_int8` (the Pallas kernel in interpret mode), 2 images,
    2 heads, per-section quantized qkv."""
    h = 2
    d = h * dh
    x = _qkv(60 + n + dh, shape=(2, n, 3 * d), scale=0.5)
    sec = (np.abs(x.reshape(-1, 3, d)).max(axis=(0, 2)) / 127.0).astype(np.float32)
    q = np.clip(np.round(x / np.repeat(sec, d)), -127, 127).astype(np.int8)
    inv = None
    if int8_out:
        ref = _np(j_packed_int8(jnp.asarray(q), jnp.asarray(sec), h))
        inv = np.float32(127.0 / np.abs(ref).max())
    want = j_packed_int8(jnp.asarray(q), jnp.asarray(sec), h, out_inv_scale=inv,
                         int8_out=int8_out)
    got = packed_attention_int8(torch.from_numpy(q), torch.from_numpy(sec), h,
                                out_inv_scale=None if inv is None else torch.tensor(inv),
                                int8_out=int8_out)
    assert got.dtype == (torch.int8 if int8_out else torch.bfloat16)
    assert got.shape == (2, n, d)
    _int8_close(got, want, int8_out)


# --------------------------------------------------------- elementwise ----

_GRID = np.linspace(-10.0, 10.0, 4001, dtype=np.float32)


@pytest.mark.parametrize("name", ["gelu_erf_tanh", "gelu_erf", "erf_tanh", "erf"])
def test_gelu_matches_jax(name):
    """Same f32 formulas: 1e-6 max abs (transcendental ulps)."""
    want = getattr(jgelu, name)(jnp.asarray(_GRID))
    got = getattr(tgelu, name)(torch.from_numpy(_GRID))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)
    # bf16 in -> bf16 out, one bf16 ulp
    gb = getattr(tgelu, name)(torch.from_numpy(_GRID).bfloat16())
    wb = getattr(jgelu, name)(jnp.asarray(_GRID, jnp.bfloat16))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(gb), _np(wb), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(out_dtype):
    """f32 statistics: f32 out 1e-5; bf16 out one bf16 ulp (rtol 2^-7)."""
    from msvit_tpu.models.base.norm import LayerNorm as JLN
    from msvit_tpu_torch.models.base.norm import LayerNorm as TLN

    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 11, D)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    want = JLN(epsilon=1e-6, out_dtype=getattr(jnp, out_dtype)).apply(
        {"params": {"scale": w, "bias": b}}, jnp.asarray(x))
    ln = TLN(D, 1e-6, out_dtype=getattr(torch, out_dtype))
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x))
    assert got.dtype == getattr(torch, out_dtype)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------- int8 ----


def _weight(seed, k=96, n=40):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)


def test_quantize_weight_matches_jax():
    """int8 values equal and scales equal (the port keeps [out, in])."""
    w = _weight(7)
    jq = jquant.quantize_weight(jnp.asarray(w))
    tq = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values).T)
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale)[0])


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_matches_jax(static, requant):
    """int8 GEMM, dynamic or calibrated activation scale, dequant or
    requant epilogue.  Dequant (f32 out): 1e-5 relative; requant (int8
    out): |delta| <= 1 and >= 99% equal (one rounding at a .5 boundary)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 13, 96)).astype(np.float32)
    w = _weight(9)
    bias = rng.standard_normal(40).astype(np.float32) * 0.1
    act = np.float32(np.abs(x).max() / 127 * 1.1) if static else None
    inv = (np.float32(1.0) / np.linspace(0.01, 0.05, 40, dtype=np.float32)
           if requant else None)
    jq = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.int8_matmul(
        jnp.asarray(x), jq, jnp.asarray(bias), out_dtype=jnp.float32,
        act_scale=None if act is None else jnp.asarray(act),
        out_inv_scale=None if inv is None else jnp.asarray(inv)))
    tq = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    got = tquant.int8_matmul(
        torch.from_numpy(x), tq, torch.from_numpy(bias),
        out_dtype=torch.float32,
        act_scale=None if act is None else torch.tensor(act),
        out_inv_scale=None if inv is None else torch.from_numpy(inv)).numpy()
    assert got.shape == want.shape == (2, 13, 40)
    if requant:
        assert got.dtype == np.int8
        delta = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert delta.max() <= 1 and (delta == 0).mean() >= 0.99
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- imports ----


def test_port_imports_no_jax():
    """`msvit_tpu_torch` and every submodule import without JAX or the
    JAX package (the card's machine has no JAX)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import msvit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'msvit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'msvit_tpu' or m.startswith('msvit_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
