"""PyTorch port against the TPU's head-grouped packed kernels: K8a
`_packed_forward_grouped` (both branches) and K8b
`_packed_backward_grouped`, run in interpret mode as the JAX package's own
tests run them off the TPU.

The port has no kernels of its own for them: its K1, K1-lse and K2 stand
for the grouped functions too (the same arithmetic on another grid), so
their plain versions are held against the grouped functions here, at the
grouped kernels' shapes (dh = 64, a head pair 128 lanes wide) and masks
(none, bool [B,1,N,N], additive per head [B,H,N,N]).

Tolerances, as tests/test_torch_ops.py uses for K1 / K1-lse / K2: f32 1e-5
(out), 1e-5 relative (lse), 1e-4 of max |dqkv|; bf16 2e-2 (out) and 3e-2 of
max |dqkv|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msvit_tpu.ops.packed_attention as jpa
from msvit_tpu.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu_torch.ops.packed_attention import (
    PackedAttentionFunction,
    packed_attention_bwd_plain,
    packed_attention_lse_plain,
    packed_attention_plain,
)

B, H, DH = 2, 4, 64
D = H * DH
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # f32 sums of bf16 products
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # of max(1, max |dqkv|)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, n, 3 * D)).astype(np.float32) * scale
    g = rng.standard_normal((B, n, D)).astype(np.float32)
    return qkv, g


def _mask(kind, seed, n):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        m = rng.random((B, 1, n, n)) < 0.7
        return m | np.eye(n, dtype=bool)[None, None]
    if kind == "additive":  # per head: the hg-sliced BlockSpec
        return (-100.0 * (rng.random((B, H, n, n)) < 0.3)).astype(np.float32)
    return None


def _j(x, dtype=None):
    return None if x is None else jnp.asarray(x, dtype)


def _t(x, dtype=None):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _scaled(got, want, tol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


CASES = [(40, None), (40, "bool"), (40, "additive"), (37, "additive"), (37, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,mask_kind", CASES)
def test_k1_plain_matches_grouped_inference(dtype, n, mask_kind):
    """K1's plain version vs K8a's inference branch (the shaved softmax,
    l summed from the rounded p by a `pb @ ones` dot)."""
    x, _ = _inputs(0, n)
    m = _mask(mask_kind, 1, n)
    scale = DH**-0.5
    want = jpa._packed_forward_grouped(
        _j(x, getattr(jnp, dtype)), _j(m), H, scale, DEFAULT_MASK_VALUE, head_group=2)
    got = packed_attention_plain(_t(x, getattr(torch, dtype)), H, _t(m), scale)
    assert got.shape == (B, n, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=OUT_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,mask_kind", CASES)
def test_k1_lse_plain_matches_grouped_training(dtype, n, mask_kind):
    """K1-lse's plain version vs K8a's `with_lse` branch: out and lse."""
    x, _ = _inputs(2, n)
    m = _mask(mask_kind, 3, n)
    scale = DH**-0.5
    wo, wl = jpa._packed_forward_grouped(
        _j(x, getattr(jnp, dtype)), _j(m), H, scale, DEFAULT_MASK_VALUE,
        head_group=2, with_lse=True)
    go, gl = packed_attention_lse_plain(_t(x, getattr(torch, dtype)), H, _t(m), scale)
    assert gl.shape == (B, H, n) and gl.dtype == torch.float32
    np.testing.assert_allclose(_np(go), _np(wo), atol=OUT_TOL[dtype], rtol=0)
    wl = _np(wl)
    assert (np.abs(_np(gl) - wl) / np.maximum(1.0, np.abs(wl))).max() <= LSE_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,mask_kind", CASES)
def test_k2_plain_matches_grouped_backward(dtype, n, mask_kind):
    """K2's plain version vs K8b on the same residuals (JAX's grouped
    forward's out and lse) and cotangent.  The masks are 0 / -100, which
    bf16 holds exactly, so K8b's bf16 mask changes nothing."""
    x, g = _inputs(4, n)
    m = _mask(mask_kind, 5, n)
    scale = DH**-0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, lse = jpa._packed_forward_grouped(
        _j(x, jdt), _j(m), H, scale, DEFAULT_MASK_VALUE, head_group=2, with_lse=True)
    want = jpa._packed_backward_grouped(
        _j(x, jdt), _j(m), out, lse, _j(g, jdt), H, scale, DEFAULT_MASK_VALUE)
    got = packed_attention_bwd_plain(
        _t(x, tdt), _t(m), torch.from_numpy(_np(out).copy()).to(tdt),
        torch.from_numpy(_np(lse).copy()), _t(g, tdt), H, scale)
    assert got.shape == (B, n, 3 * D) and got.dtype == tdt
    _scaled(got, want, BWD_TOL[dtype])


@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
def test_function_matches_jax_grad_with_grouped_backward(mask_kind):
    """`PackedAttentionFunction` vs `jax.grad` of `packed_attention` with
    the grouped backward forced through the module attribute (f32)."""
    n = 40
    x, g = _inputs(6, n)
    m = _mask(mask_kind, 7, n)

    def loss(q):
        return jnp.sum(jpa.packed_attention(q, H, mask=_j(m)) * jnp.asarray(g))

    old = jpa._BWD_IMPL
    try:
        jpa._BWD_IMPL = "grouped"
        want = jax.jit(jax.grad(loss))(jnp.asarray(x))
    finally:
        jpa._BWD_IMPL = old
    xt = torch.from_numpy(x).requires_grad_()
    out = PackedAttentionFunction.apply(xt, _t(m), H, DH**-0.5, DEFAULT_MASK_VALUE)
    out.backward(torch.from_numpy(g))
    _scaled(xt.grad, want, BWD_TOL["float32"])


def test_large_logits_match_grouped_kernels():
    """Scores in the hundreds (q and k x 12): the grouped training forward
    and backward stay exact, and so do the plain versions (f32; out at
    1e-4: one ulp of a score near 300 is 3e-5, and exp carries it into p)."""
    n = 40
    x, g = _inputs(8, n)
    x[..., :2 * D] *= 12.0
    scale = DH**-0.5
    out, lse = jpa._packed_forward_grouped(
        jnp.asarray(x), None, H, scale, DEFAULT_MASK_VALUE, head_group=2, with_lse=True)
    assert float(jnp.max(jnp.abs(lse))) > 150.0
    want = jpa._packed_backward_grouped(
        jnp.asarray(x), None, out, lse, jnp.asarray(g), H, scale, DEFAULT_MASK_VALUE)
    go, gl = packed_attention_lse_plain(torch.from_numpy(x), H, None, scale)
    got = packed_attention_bwd_plain(torch.from_numpy(x), None, go, gl,
                                     torch.from_numpy(g), H, scale)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(go), _np(out), atol=1e-4, rtol=0)
    _scaled(got, want, BWD_TOL["float32"])


def test_bf16_mask_deviation_is_pinned():
    """K8b ships an additive mask as bf16; K8a and K2 ship it as f32, and
    so do the port's K2 and its plain version, whatever N.  With a mask
    bf16 cannot hold (-3.3 -> -3.296875) the port's backward equals JAX's
    K2 (`_packed_backward`), equals K8b only once the mask is rounded by
    hand, and differs from K8b otherwise (f32, 1e-4 of max |dqkv|)."""
    n = 40
    x, g = _inputs(9, n)
    rng = np.random.default_rng(10)
    m = (-3.3 * (rng.random((B, H, n, n)) < 0.5)).astype(np.float32)
    m_bf16 = torch.from_numpy(m).bfloat16().float()
    assert not torch.equal(m_bf16, torch.from_numpy(m))
    scale = DH**-0.5
    out, lse = jpa._packed_forward_grouped(
        jnp.asarray(x), jnp.asarray(m), H, scale, DEFAULT_MASK_VALUE,
        head_group=2, with_lse=True)  # the forward reads the f32 mask
    args = (jnp.asarray(x), jnp.asarray(m), out, lse, jnp.asarray(g), H, scale,
            DEFAULT_MASK_VALUE)
    k2, k8b = jpa._packed_backward(*args), jpa._packed_backward_grouped(*args)

    def port(mask):
        return packed_attention_bwd_plain(
            torch.from_numpy(x), mask, torch.from_numpy(_np(out).copy()),
            torch.from_numpy(_np(lse).copy()), torch.from_numpy(g), H, scale)

    _scaled(port(torch.from_numpy(m)), k2, BWD_TOL["float32"])
    _scaled(port(m_bf16), k8b, BWD_TOL["float32"])
    bar = BWD_TOL["float32"] * max(1.0, np.abs(_np(k8b)).max())
    assert np.abs(_np(port(torch.from_numpy(m))) - _np(k8b)).max() > 2 * bar  # measured: 4 x the bar


# (N, element bytes, masked) -> (forward, backward) of JAX's `packed_attention`
# at ViT-B's width (D = 768, H = 12) on its kernel device, bs64.  "packed" /
# "kernel" are K1 / K2, "grouped" K8a / K8b.
ROUTES = [
    (197, 2, False, "packed", "kernel"),
    (197, 4, False, "packed", "kernel"),
    (197, 2, True, "packed", "kernel"),
    (197, 4, True, "packed", "grouped"),
    (785, 2, False, "grouped", "grouped"),
    (785, 4, False, "grouped", "grouped"),
    (816, 2, True, "grouped", "grouped"),
    (816, 4, True, "xla", "grouped"),
    (1025, 2, False, "grouped", "grouped"),
    (1370, 2, False, "xla", "grouped"),
    (3137, 2, False, "xla", "flash"),
]


@pytest.mark.parametrize("n,elem_bytes,masked,fwd,bwd", ROUTES)
def test_jax_routes_at_vit_b(n, elem_bytes, masked, fwd, bwd):
    """Which TPU function each regime reaches, from the JAX package's own
    four VMEM gates: the table the port's records (PERF.md, ROADMAP.md)
    state.  The forward is `_dispatch_variant`; the backward repeats the
    "auto" chain of `_packed_bwd`."""
    d, h, b = 768, 12, 64
    dt = jnp.bfloat16 if elem_bytes == 2 else jnp.float32
    qkv = jax.ShapeDtypeStruct((b, n, 3 * d), dt)
    assert jpa._dispatch_variant(qkv, object() if masked else None, h) == fwd
    if jpa.packed_bwd_vmem_ok(n, d, h, elem_bytes=elem_bytes, has_mask=masked):
        got = "kernel"
    elif jpa.grouped_bwd_vmem_ok(n, d, h, elem_bytes=elem_bytes, has_mask=masked):
        got = "grouped"
    elif n >= 512 or b * h * n * n * 4 > jpa._CLOSED_FORM_MAX_BYTES:
        got = "flash"
    else:
        got = "closed"
    assert got == bwd
