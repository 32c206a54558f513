"""PyTorch port, K7 (flash attention) and K6 (its backward) against the
JAX package (CPU):

* the plain versions of K7 and K7-lse against the Pallas `_flash_forward`
  in interpret mode, at a shape that crosses its 512-row and 1024-key
  tiles, with every kind of mask; K6's plain version against the Pallas
  `flash_attention_bwd` where the card's 64-row tiles have edges;
* the fully masked row: the TPU kernel's padded keys against the port's
  mean(V);
* `FlashAttentionFunction` against `jax.grad` of JAX's `flash_attention`,
  and gradcheck in f64;
* the multistate model with `attn_implementation="flash"` against JAX's,
  with JAX's clustering draws; the converter at a 448-px position table."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msvit_tpu.ops.flash_attention as jflash
from msvit_tpu.models import multistate as jms
import msvit_tpu_torch.ops.flash_attention as tflash
from msvit_tpu_torch.compat import multistate_params_from_jax
from msvit_tpu_torch.models import multistate as tms
from test_torch_clustering import JaxRng
from test_torch_multistate import _cfgs, _close, _event_margins, _np, _pair, _pixels

B, H, NQ, NK, DH = 1, 2, 600, 1100, 16  # crosses the 512-row and 1024-key tiles
_MASKS = ["none", "bool", "additive", "additive_per_head"]


def _qkv(seed, nq=NQ, nk=NK, b=B, h=H, dh=DH):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, dh)).astype(np.float32)
                 for n in (nq, nk, nk))


def _mask(kind, seed, nq=NQ, nk=NK):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "bool":  # [B, 1, Nq, Nk]; every row keeps a key
        m = rng.random((B, 1, nq, nk)) < 0.7
        m[..., 0] = True
        return m
    hm = H if kind == "additive_per_head" else 1
    return np.where(rng.random((B, hm, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_flash():
    """`_flash_forward` in interpret mode with its lse, one call per mask."""
    cache = {}

    def get(kind):
        if kind not in cache:
            q, k, v = _qkv(1)
            m = _mask(kind, 2)
            out, lse = jflash._flash_forward(
                *(jnp.asarray(t) for t in (q, k, v)), None if m is None else jnp.asarray(m),
                scale=DH**-0.5, mask_value=tflash.DEFAULT_MASK_VALUE, with_lse=True)
            cache[kind] = (_np(out), np.asarray(lse)[:, :, :NQ, 0])
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_plain_matches_jax(jax_flash, kind, with_lse):
    """K7 (and K7-lse) plain vs `_flash_forward` (interpret mode) at
    [1, 2, 600, 1100, 16], f32: out and lse <= 1e-3 max abs (the online
    softmax's order of sums only; measured near 1e-6).  The wrappers on CPU
    tensors run the plain versions (no launch)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1))
    m = _mask(kind, 2)
    m = None if m is None else torch.from_numpy(m)
    want_out, want_lse = jax_flash(kind)
    before = (tflash.flash_attention.launches, tflash.flash_attention_lse.launches)
    if with_lse:
        out, lse = tflash.flash_attention_lse(q, k, v, mask=m)
        assert lse.shape == (B, H, NQ) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-3, rtol=0)
    else:
        out = tflash.flash_attention(q, k, v, mask=m)
    assert (tflash.flash_attention.launches, tflash.flash_attention_lse.launches) == before
    assert out.shape == (B, H, NQ, DH)
    np.testing.assert_allclose(_np(out), want_out, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,dh", [(65, 129, 40), (130, 70, 128)])
def test_flash_plain_matches_jax_at_tile_edges(dtype, nq, nk, dh):
    """The contract the card's bf16 tensor-core K7 is held to, where its
    64-row tiles have edges: Nq and Nk one past a tile or a partial third
    one, Nq != Nk both ways, dh 40 (zero-padded to 64) and 128.  K7 and
    K7-lse plain vs `_flash_forward` (interpret mode) with an additive
    per-head mask, 2 heads: out f32 1e-3 max abs as above, bf16 2e-2 (p
    rounded to bf16 on both sides, against the row's max here and the
    running max of a 512-row, 1024-key tile there); lse 1e-3 (f32 in
    both)."""
    h = 2
    rng = np.random.default_rng(nq + nk + dh)
    q, k, v = (rng.standard_normal((B, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))
    m = np.where(rng.random((B, h, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_l = jflash._flash_forward(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(m), scale=dh**-0.5,
        mask_value=tflash.DEFAULT_MASK_VALUE, with_lse=True)
    tq, tk, tv = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    out, lse = tflash.flash_attention_lse_plain(tq, tk, tv, mask=torch.from_numpy(m))
    got = tflash.flash_attention_plain(tq, tk, tv, mask=torch.from_numpy(m))
    assert torch.equal(got, out) and got.dtype == tdt and got.shape == (B, h, nq, dh)
    atol = 2e-2 if dtype == "bfloat16" else 1e-3
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_l)[:, :, :nq, 0], atol=1e-3,
                               rtol=0)


# (Nq, Nk, dh, mask): Nq and Nk one short of, on and one past a 64-row
# tile, and two tiles plus one, Nq != Nk both ways; dh 8, 24, 40 and 72
# (zero-padded to 16/32/64/128 on the card); bool (row 0 fully masked),
# additive per head and broadcast
_BWD_EDGES = [(63, 65, 8, "bool"), (64, 129, 24, "additive_per_head"),
              (65, 64, 40, "additive"), (129, 63, 72, "bool"),
              (129, 129, 40, "additive_per_head")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,dh,kind", _BWD_EDGES)
def test_flash_bwd_plain_matches_jax_at_tile_edges(dtype, nq, nk, dh, kind):
    """The contract the card's bf16 tensor-core K6 is held to, where its
    64-row tiles have edges: `flash_attention_bwd_plain` against the Pallas
    `flash_attention_bwd` (interpret mode) on the same residuals (the plain
    forward's out and compact lse) and cotangent, 2 heads: dq, dk, dv f32
    1e-5 and bf16 2e-2 of max(1, max |JAX|) (both round p and ds to bf16
    at the same places; f32 sums in another order).  A bool mask's row 0
    is fully masked: its lse rounds to mask_value and p = 1 on every key,
    so with the cotangent on that row alone dv of every key is that row's
    g, exactly, on both sides."""
    h = 2
    rng = np.random.default_rng(nq * 7 + nk + dh)
    q, k, v = (rng.standard_normal((B, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))
    g = rng.standard_normal((B, h, nq, dh)).astype(np.float32)
    if kind == "bool":
        m = rng.random((B, 1, nq, nk)) < 0.7
        m[:, :, 0] = False
    else:
        hm = h if kind == "additive_per_head" else 1
        m = np.where(rng.random((B, hm, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(t).to(tdt) for t in (q, k, v, g))
    tm = torch.from_numpy(m)
    out, lse = tflash.flash_attention_lse_plain(tq, tk, tv, mask=tm)
    before = tflash.flash_attention_bwd.launches
    g_only0 = torch.zeros_like(tg)
    g_only0[:, :, 0] = tg[:, :, 0]
    for cot in (tg, g_only0) if kind == "bool" else (tg,):
        want = jflash.flash_attention_bwd(
            *(jnp.asarray(_np(t), jdt) for t in (tq, tk, tv, out, cot)), jnp.asarray(_np(lse)),
            jnp.asarray(m), scale=dh**-0.5, mask_value=tflash.DEFAULT_MASK_VALUE)
        got = tflash.flash_attention_bwd(tq, tk, tv, out, cot, lse, mask=tm)
        for a, b in zip(got, want):
            assert a.dtype == tdt and tuple(a.shape) == b.shape
            tol = (1e-5 if dtype == "float32" else 2e-2) * max(1.0, float(np.abs(_np(b)).max()))
            np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)
    assert tflash.flash_attention_bwd.launches == before
    if kind == "bool":  # p = 1 on the fully masked row
        row = np.broadcast_to(_np(g_only0)[:, :, :1], (B, h, nk, dh))
        np.testing.assert_array_equal(_np(got[2]), row)
        np.testing.assert_array_equal(_np(want[2]), row)


def test_fully_masked_row_deviation():
    """A bool row with every key masked, at Nk = 1100: the TPU kernel pads
    Nk to nk_pad = 2048 (bk = 1024) and counts the padded keys (zero V rows)
    with p = 1, so the row is sum(V) / 2048; the port gives mean(V) over the
    1100 real keys.  Every other row agrees with JAX to 1e-5 (f32)."""
    nq = 40
    q, k, v = _qkv(3, nq=nq)
    m = np.random.default_rng(4).random((B, H, nq, NK)) < 0.7
    m[..., 0] = True
    m[0, 1, 5, :] = False
    flat = np.zeros((B, H, nq), bool)
    flat[0, 1, 5] = True
    want, _ = jflash._flash_forward(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(m),
                                    scale=DH**-0.5, mask_value=tflash.DEFAULT_MASK_VALUE)
    want = _np(want)
    got = _np(tflash.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                     mask=torch.from_numpy(m)))
    vsum = v[0, 1].sum(0)
    np.testing.assert_allclose(want[0, 1, 5], vsum / 2048, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0, 1, 5], vsum / NK, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[~flat], want[~flat], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["none", "additive_per_head"])
def test_flash_function_grads_match_jax(kind):
    """Autograd through the port's `flash_attention` on the CPU
    (`FlashAttentionFunction`: K7-lse forward, K6 backward, plain versions)
    against `jax.grad` of JAX's `flash_attention` (its Pallas forward and
    backward in interpret mode), [1, 2, 70, 90, 16] f32: value and dq, dk,
    dv <= 1e-3 max abs."""
    nq, nk = 70, 90
    q, k, v = _qkv(5, nq=nq, nk=nk)
    m = _mask(kind, 6, nq=nq, nk=nk)
    w = np.random.default_rng(7).standard_normal((B, H, nq, DH)).astype(np.float32)
    jm = None if m is None else jnp.asarray(m)

    def loss(a, b, c):
        return jnp.sum(jflash.flash_attention(a, b, c, mask=jm) * w)

    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want_val = float(loss(jq, jk, jv))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tm = None if m is None else torch.from_numpy(m)
    val = (tflash.flash_attention(tq, tk, tv, mask=tm) * torch.from_numpy(w)).sum()
    val.backward()
    assert abs(val.item() - want_val) <= 1e-3
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref)


def test_flash_function_gradcheck_f64():
    """`FlashAttentionFunction` in f64 (the plain versions) under
    `torch.autograd.gradcheck`, with an additive per-head mask and Nq != Nk."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, 8))).requires_grad_()
               for n in (5, 7, 7))
    m = torch.from_numpy(np.where(rng.random((1, 2, 5, 7)) < 0.3, -3.0, 0.0))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tflash.FlashAttentionFunction.apply(a, b, c, m, 0.35, -1e9),
        (q, k, v))


@pytest.mark.parametrize("events", [False, True])
def test_model_with_flash_matches_jax(events):
    """`attn_implementation="flash"` in both packages, the tiny config (f32
    parity policy): JAX's trunk layers run its Pallas `flash_attention`
    (interpret mode), the port's run `flash_attention`'s plain version; the
    last layer the plain path with probabilities in both.  With clustering
    events (layers 1 and 2) the partitions are equal (the event margins
    asserted as in test_torch_multistate); hidden states, TX tokens and
    RX -> TX attentions <= 1e-3."""
    jcfg, tcfg = _cfgs(attn_implementation="flash", generation_period=1,
                       pregeneration_period=1 if events else 99)
    pix = _pixels(seed=3)
    model, variables, tmodel = _pair(jcfg, tcfg, pix)
    key = jax.random.PRNGKey(5)
    want = model.apply(variables, jnp.asarray(pix), rng=key, output_hidden_states=True,
                       output_cluster_indices=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(pix), rng=JaxRng(key))
    if events:
        eig_margin, km_margin = _event_margins(jcfg, want, key)
        assert eig_margin >= 1e-3 and km_margin >= 1e-3, (eig_margin, km_margin)
        assert int(np.min(np.asarray(want["num_clusters"]))) >= 2
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    _close(got["last_hidden_state"], want["last_hidden_state"])
    _close(got["cluster_tokens"], want["cluster_tokens"])
    _close(got["receiver_to_transmitter_attentions"],
           want["receiver_to_transmitter_attentions"])


def test_converter_carries_a_448px_position_table():
    """`multistate_params_from_jax` on a 448-px multistate model (patch 32,
    a native 14 x 14 position table): the table arrives as it is and the
    port's forward at 448 px needs no interpolation."""
    jcfg, tcfg = _cfgs(image_size=448, patch_size=32, hidden_size=32,
                       num_attention_heads=2, num_hidden_layers=1)
    pix = np.random.default_rng(9).standard_normal((1, 448, 448, 3)).astype(np.float32)
    model = jms.MultiStateViTEncoderModel(jcfg)
    key = jax.random.PRNGKey(0)
    variables = model.init({"params": key, "clustering": key}, jnp.asarray(pix))
    sd = multistate_params_from_jax(variables, tcfg)
    table = np.asarray(variables["params"]["embeddings"]["position_embeddings"])
    assert table.shape == (1, 196, 32)
    np.testing.assert_array_equal(sd["embeddings.position_embeddings"].numpy(), table)
    tmodel = tms.MultiStateViTEncoderModel(tcfg)
    tmodel.load_state_dict(sd, strict=True)
    want = model.apply(variables, jnp.asarray(pix), rng=jax.random.PRNGKey(1))
    with torch.inference_mode():
        got = tmodel.eval()(torch.from_numpy(pix), rng=JaxRng(jax.random.PRNGKey(1)))
    _close(got["last_hidden_state"], want["last_hidden_state"])
