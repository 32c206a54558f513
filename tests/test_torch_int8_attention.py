"""PyTorch port, K9 (the masked int8 attention of the multistate trunk)
against the JAX package (CPU):

* the plain version against the Pallas `packed_attention_int8_masked` in
  interpret mode, with a bool, an additive and no mask, bf16 and int8 out;
* `quantized_multistate_apply(attn_mode="int8")` against JAX's at the tiny
  config (4 heads, dh 64: JAX's head-pair gate admits it), with and
  without clustering events."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import multistate as jms
from msvit_tpu.ops.attention import DEFAULT_MASK_VALUE
from msvit_tpu.ops.packed_attention import _packed_int8_grouped as j_int8_grouped
from msvit_tpu.ops.packed_attention import packed_attention_int8_masked as j_int8_masked
from msvit_tpu_torch.compat import act_scales_from_jax
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.ops import packed_attention as tpa
from test_torch_clustering import JaxRng
from test_torch_multistate import _cfgs, _cos, _np, _pair, _pixels

B, N, H, DH = 2, 40, 4, 64


def _inputs(mask_kind, seed=0):
    """Per-section quantized qkv [2, 40, 768] int8, its 3 scales, a mask
    [B, 1, N, N] (bool with a fully masked row, or the 0 / -100 soft mask)."""
    rng = np.random.default_rng(seed)
    d = H * DH
    x = rng.standard_normal((B, N, 3 * d)).astype(np.float32)
    sec = np.abs(x.reshape(-1, 3, d)).max((0, 2)) / 127.0
    q = np.clip(np.round(x / np.repeat(sec, d)), -127, 127).astype(np.int8)
    m = None
    if mask_kind == "bool":
        m = rng.random((B, 1, N, N)) < 0.7
        m[1, 0, 3, :] = False  # a fully masked row: mean(V) on both
    elif mask_kind == "additive":
        m = np.where(rng.random((B, 1, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)
    return q, sec.astype(np.float32), m


@pytest.mark.parametrize("int8_out", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "bool", "additive"])
def test_k9_plain_matches_jax(mask_kind, int8_out):
    """K9 plain vs JAX's Pallas kernel (interpret mode).  A pre-scaled exp
    within an ulp of an integer may truncate one step apart in the two
    frameworks (at the row max, exp(ln 127) is within an ulp of 127): int8
    out |delta| <= 1 step with >= 99% exactly equal; bf16 out <= 2% of the
    output's range (K3's bar: one probability step moves o by s_v / l).
    The wrapper on CPU tensors runs the plain version (no launch)."""
    q, sec, m = _inputs(mask_kind)
    inv = np.float32(5.0) if int8_out else None
    want = _np(j_int8_masked(jnp.asarray(q), jnp.asarray(sec), H,
                             mask=None if m is None else jnp.asarray(m),
                             out_inv_scale=inv, int8_out=int8_out))
    before = tpa.packed_attention_int8_masked.launches
    got = tpa.packed_attention_int8_masked(
        torch.from_numpy(q), torch.from_numpy(sec), H,
        mask=None if m is None else torch.from_numpy(m),
        out_inv_scale=None if inv is None else torch.tensor(inv), int8_out=int8_out)
    assert tpa.packed_attention_int8_masked.launches == before
    assert got.dtype == (torch.int8 if int8_out else torch.bfloat16)
    assert got.shape == (B, N, H * DH)
    got = _np(got)
    if int8_out:
        delta = np.abs(got - want)
        assert delta.max() <= 1 and (delta == 0).mean() >= 0.99
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("int8_out", [False, True])
@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
@pytest.mark.parametrize("n", [31, 33, 65, 129])
@pytest.mark.parametrize("dh", [16, 40, 64, 128])
def test_k9_plain_matches_jax_at_tile_edges(dh, n, mask_kind, int8_out):
    """The contract the card's int8 tensor-core K9 is held to, pinned with
    the JAX package as the answer where the kernel's tiles have edges: N
    one short of and one past its 32-key k-steps and 64-key tiles, head
    sizes it pads to its 32-byte k-depth (16, 40).  K9 plain vs the Pallas
    kernel `_packed_int8_grouped` in interpret mode (called below its
    wrapper, whose VMEM gate admits only dh 64 and 128), 2 images, 2 heads,
    a bool mask with a fully masked row or the 0 / -100 soft mask per head.
    The bars of `test_k9_plain_matches_jax`."""
    h = 2
    d = h * dh
    rng = np.random.default_rng(70 + n + dh)
    x = rng.standard_normal((2, n, 3 * d)).astype(np.float32)
    sec = (np.abs(x.reshape(-1, 3, d)).max((0, 2)) / 127.0).astype(np.float32)
    q = np.clip(np.round(x / np.repeat(sec, d)), -127, 127).astype(np.int8)
    if mask_kind == "bool":
        m = rng.random((2, 1, n, n)) < 0.7
        m[0, 0, 2, :] = False  # a fully masked row: mean(V) on both
    else:
        m = np.where(rng.random((2, h, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
    inv = np.float32(5.0) if int8_out else None
    sc = np.concatenate([sec, [0.0 if inv is None else inv]]).astype(np.float32)[None]
    want = _np(j_int8_grouped(jnp.asarray(q), jnp.asarray(sc), jnp.asarray(m), h,
                              1.0 / dh**0.5, int8_out, mask_value=DEFAULT_MASK_VALUE))
    got = tpa.packed_attention_int8_masked(
        torch.from_numpy(q), torch.from_numpy(sec), h, mask=torch.from_numpy(m),
        out_inv_scale=None if inv is None else torch.tensor(inv), int8_out=int8_out)
    assert got.dtype == (torch.int8 if int8_out else torch.bfloat16)
    assert got.shape == (2, n, d)
    got = _np(got)
    if int8_out:
        delta = np.abs(got - want)
        assert delta.max() <= 1 and (delta == 0).mean() >= 0.99
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("events", [False, True])
def test_quantized_int8_attention_matches_jax(events):
    """`attn_mode="int8"` with kernels on both sides (JAX's K9 in interpret
    mode, the port's plain version) from JAX's calibrated scales: equal
    partitions, cosine >= 0.999 (test_quantized_apply_matches_jax's bar) for
    the hidden states, TX tokens and RX -> TX attentions."""
    jcfg, tcfg = _cfgs(pregeneration_period=1 if events else 99, generation_period=1)
    pix = _pixels(seed=0)
    _, variables, tmodel = _pair(jcfg, tcfg, pix)
    jq = jms.quantize_multistate_params(variables["params"])
    tq = tms.quantize_multistate_params(tmodel)
    key = jax.random.PRNGKey(9)
    js = jms.calibrate_multistate_act_scales(jq, jcfg, jnp.asarray(pix), key, use_kernels=False)
    want = jms.quantized_multistate_apply(jq, jcfg, jnp.asarray(pix), key, act_scales=js,
                                          use_kernels=True, attn_mode="int8")
    before = tpa.packed_attention_int8_masked.launches
    got = tms.quantized_multistate_apply(tq, tcfg, torch.from_numpy(pix), JaxRng(key),
                                         act_scales=act_scales_from_jax(js), use_kernels=True,
                                         attn_mode="int8")
    assert tpa.packed_attention_int8_masked.launches == before  # CPU: plain versions
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    for name in ("last_hidden_state", "cluster_tokens", "receiver_to_transmitter_attentions"):
        assert _cos(got[name], want[name]) >= 0.999, name


def test_int8_mode_needs_kernels_and_scales():
    """As in JAX, "int8" falls back to the bf16 attention without kernels
    or without calibrated scales: the outputs equal `attn_mode="bf16"`'s."""
    _, tcfg = _cfgs(pregeneration_period=99)
    tmodel = tms.MultiStateViTEncoderModel(tcfg).eval()
    tq = tms.quantize_multistate_params(tmodel)
    pix = torch.from_numpy(_pixels(seed=1))
    scales = tms.calibrate_multistate_act_scales(tq, tcfg, pix, 0)
    for kw in (dict(use_kernels=False, act_scales=scales), dict(use_kernels=True)):
        a = tms.quantized_multistate_apply(tq, tcfg, pix, 0, attn_mode="int8", **kw)
        b = tms.quantized_multistate_apply(tq, tcfg, pix, 0, attn_mode="bf16", **kw)
        assert torch.equal(a["last_hidden_state"], b["last_hidden_state"])
