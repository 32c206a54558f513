"""PyTorch port, K10 (cluster-banded multistate attention) against the JAX
package (CPU):

* the band table against `_band_limits`, at JAX's block sizes and at the
  port's own;
* the token rows' plain version against the Pallas `_token_rows_banded`
  (interpret mode) and `_token_rows_xla`, one block, several blocks and
  several 1024-key chunks, and where the card's 64-row blocks, 64-key
  tiles and 16-key blocks have edges;
* `multistate_banded_attention` (prefix rows and RX -> TX included) and the
  token rows' gradient against JAX;
* the banded multistate model against JAX's banded model with JAX's draws,
  and against the port's dense model; `attn_mode="banded"` of the int8
  apply against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msvit_tpu.ops.banded_attention as jband
from msvit_tpu.models import multistate as jms
import msvit_tpu_torch.ops.banded_attention as tband
from msvit_tpu_torch.compat import act_scales_from_jax
from msvit_tpu_torch.models import multistate as tms
from test_torch_clustering import JaxRng
from test_torch_multistate import _cfgs, _close, _cos, _event_margins, _np, _pair, _pixels


def _sorted_cid(sizes):
    return np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]).astype(np.int32)


# (sizes per image, clusters C, heads, dh): one 128-block; several blocks
# with clusters across their edges; more than 1024 keys (two TPU chunks)
_CASES = {
    "small": ([[10, 2, 12], [1, 15, 8]], 4, 2, 8),
    "multiblock": ([[150, 100, 50]], 4, 2, 8),
    "multichunk": ([[500, 400, 200, 100]], 4, 2, 8),
}


def _case(name, seed=0, dtype=np.float32):
    sizes, c, heads, dh = _CASES[name]
    cid = np.stack([_sorted_cid(s) for s in sizes])
    b, n = cid.shape
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, 2 * c + n, 3 * heads * dh)).astype(dtype)
    return qkv, cid, c, heads


@pytest.mark.parametrize("blocks", [128, 64])
@pytest.mark.parametrize("sizes", [[150, 100, 50], [64, 64, 1, 171], [300]])
def test_band_limits_match_jax(monkeypatch, blocks, sizes):
    """`band_limits` against JAX's `_band_limits`: at JAX's 128 x 128 blocks,
    and at the port's 64 x 64 (JAX's module constants patched), the same
    [kmin, kmax] tiles; and each row block's band holds exactly the keys of
    the clusters of its rows (checked against the cluster ids)."""
    monkeypatch.setattr(jband, "_BQ", blocks)
    monkeypatch.setattr(jband, "_BK", blocks)
    cid = _sorted_cid(sizes)[None]
    n = cid.shape[1]
    nqb = -(-n // blocks)
    want = np.asarray(jband._band_limits(jnp.asarray(cid), 4, nqb))
    got = tband.band_limits(torch.from_numpy(cid), 4, rows=blocks, keys=blocks)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for qb in range(nqb):
        rows = cid[0, qb * blocks:(qb + 1) * blocks]
        live = np.flatnonzero(np.isin(cid[0], rows))
        kmin, kmax = got[0, :, qb].tolist()
        assert kmin * blocks <= live.min() and live.max() < (kmax + 1) * blocks
        assert live.min() // blocks == kmin and live.max() // blocks == kmax


@pytest.fixture(scope="module")
def jax_rows():
    """`_token_rows_banded` (interpret mode) and `_token_rows_xla`, per case
    and dtype."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            qkv, cid, c, heads = _case(name)
            x = jnp.asarray(qkv, getattr(jnp, dtype))
            cache[name, dtype] = (
                _np(jband._token_rows_banded(x, jnp.asarray(cid), heads, c)),
                _np(jband._token_rows_xla(x, jnp.asarray(cid), heads, c)))
        return cache[name, dtype]

    return get


@pytest.mark.parametrize("name", list(_CASES))
def test_token_rows_plain_matches_jax(jax_rows, name):
    """f32: the plain version against the Pallas kernel and against
    `_token_rows_xla` <= 1e-5 (rounding p to f32 changes nothing, so the two
    orders of l agree).  The wrapper on CPU tensors runs the plain version
    (no launch)."""
    qkv, cid, c, heads = _case(name)
    before = tband.token_rows.launches
    got = tband.token_rows(torch.from_numpy(qkv), torch.from_numpy(cid).long(), heads, c)
    assert tband.token_rows.launches == before
    assert got.shape == (qkv.shape[0], cid.shape[1], qkv.shape[2] // 3)
    kernel, xla = jax_rows(name, "float32")
    np.testing.assert_allclose(_np(got), kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got), xla, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["small", "multiblock"])
def test_token_rows_plain_takes_the_kernels_rounding(jax_rows, name):
    """bf16: the plain version sums the bf16-rounded p into l, as the TPU
    kernel does (`_token_rows_xla` sums the unrounded p): it agrees with the
    kernel within one bf16 step of the output (2e-2), and at least as
    closely as `_token_rows_xla` does."""
    qkv, cid, c, heads = _case(name)
    got = _np(tband.token_rows(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(cid), heads, c))
    kernel, xla = jax_rows(name, "bfloat16")
    err = np.abs(got - kernel).max()
    assert err <= 2e-2
    assert np.abs(got - kernel).mean() <= np.abs(xla - kernel).mean()


# cluster sizes of one image: N 63, 65 and 129; boundaries on a 16-key
# block (16, 32), on a 64-key tile (64) and inside both, one-token
# clusters, one cluster holding every token
_EDGES = {"one-cluster-63": [63], "65": [16, 1, 48], "129": [64, 17, 1, 47],
          "129-blocks": [5, 11, 16, 33, 64], "one-cluster-129": [129]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_EDGES))
def test_token_rows_plain_matches_jax_at_tile_edges(dtype, name):
    """The contract the card's bf16 tensor-core K10 is held to, where its
    64-row blocks, 64-key tiles and 16-key blocks have edges: the plain
    version against the Pallas `_token_rows_banded` (interpret mode) and
    `_token_rows_xla`, C = 8 slots, 2 heads of 16, the q third pre-scaled.
    f32 <= 1e-5 against both; bf16 within one bf16 step of the output
    (2e-2) of the Pallas kernel, whose rounding it takes (p rounded, l
    summed from the rounded p)."""
    cid = _sorted_cid(_EDGES[name])[None]
    n, c, heads, dh = cid.shape[1], 8, 2, 16
    qkv = np.random.default_rng(n + len(_EDGES[name])).standard_normal(
        (1, 2 * c + n, 3 * heads * dh)).astype(np.float32)
    qkv[..., :heads * dh] *= dh**-0.5
    x = jnp.asarray(qkv, getattr(jnp, dtype))
    kernel = _np(jband._token_rows_banded(x, jnp.asarray(cid), heads, c))
    got = _np(tband.token_rows(torch.from_numpy(qkv).to(getattr(torch, dtype)),
                               torch.from_numpy(cid), heads, c))
    if dtype == "float32":
        xla = _np(jband._token_rows_xla(x, jnp.asarray(cid), heads, c))
        np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, kernel, atol=2e-2, rtol=0)


@pytest.mark.parametrize("rx_tx", [False, True])
def test_multistate_banded_attention_matches_jax(rx_tx):
    """The full op (prefix rows with the soft mask, K10's token rows) and
    the RX -> TX probabilities against JAX's, f32, per-image cluster counts:
    <= 1e-5."""
    qkv, cid, c, heads = _case("small", seed=1)
    nc = cid.max(1) + 1
    want = jband.multistate_banded_attention(
        jnp.asarray(qkv), jband.BandedSegments(jnp.asarray(cid), jnp.asarray(nc), c, 1e2),
        heads, output_rx_tx=rx_tx)
    got = tband.multistate_banded_attention(
        torch.from_numpy(qkv), tband.BandedSegments(torch.from_numpy(cid).long(),
                                                    torch.from_numpy(nc), c, 1e2),
        heads, output_rx_tx=rx_tx)
    if rx_tx:
        (got, got_p), (want, want_p) = got, want
        assert got_p.shape == (qkv.shape[0], heads, c, c)
        np.testing.assert_allclose(_np(got_p), _np(want_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_token_rows_grad_matches_jax():
    """The port's `TokenRowsFunction` (its backward differentiates the plain
    version) against `jax.grad` through JAX's custom VJP, f32: <= 1e-5."""
    qkv, cid, c, heads = _case("small", seed=2)
    w = np.random.default_rng(3).standard_normal(
        (qkv.shape[0], cid.shape[1], qkv.shape[2] // 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jband._token_rows(a, jnp.asarray(cid), heads, c) * w))(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    (tband.token_rows(x, torch.from_numpy(cid), heads, c) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(x.grad), _np(want), atol=1e-5, rtol=0)


def test_token_rows_gradcheck_f64():
    qkv, cid, c, heads = _case("small", seed=4)
    x = torch.from_numpy(qkv[:1, :, :].astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: tband.token_rows(a, torch.from_numpy(cid[:1]), heads, c), (x,))


def _model_run(jcfg, tcfg, pix, key):
    model, variables, tmodel = _pair(jcfg, tcfg, pix)
    want = model.apply(variables, jnp.asarray(pix), rng=key, output_hidden_states=True,
                       output_cluster_indices=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(pix), rng=JaxRng(key), output_hidden_states=True,
                     output_cluster_indices=True)
    return want, got, tmodel


def test_banded_model_matches_jax_and_dense():
    """The banded multistate model (tiny config, f32 parity policy,
    clustering at layers 1 and 2) against JAX's banded model with JAX's
    draws: equal partitions (the event margins asserted), hidden states
    (every layer's, unsorted), TX tokens and RX -> TX attentions <= 1e-3;
    and against the port's dense model with the same weights and draws:
    equal partitions, the same patch tokens and valid clusters' TX tokens
    and RX -> TX attentions within 1e-3 (the dropped e^-100 leaks of the
    masked keys).  An invalid slot's fully penalised TX row differs: the
    dense path's exact softmax cancels the uniform penalty (softmax of the
    raw scores), the banded prefix rows' shaved softmax clips every score
    to -80 (uniform attention), as in JAX."""
    jcfg, tcfg = _cfgs(banded_attention=True, pregeneration_period=1, generation_period=1)
    pix = _pixels(seed=3)
    key = jax.random.PRNGKey(5)
    want, got, tmodel = _model_run(jcfg, tcfg, pix, key)
    eig_margin, km_margin = _event_margins(jcfg, want, key)
    assert eig_margin >= 1e-3 and km_margin >= 1e-3, (eig_margin, km_margin)
    assert int(np.min(np.asarray(want["num_clusters"]))) >= 2
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    for a, b in zip(got["hidden_states"], want["hidden_states"]):
        _close(a, b)
    for name in ("last_hidden_state", "cluster_tokens", "receiver_to_transmitter_attentions"):
        _close(got[name], want[name])

    dense = tms.MultiStateViTEncoderModel(_cfgs(pregeneration_period=1, generation_period=1)[1])
    dense.load_state_dict(tmodel.state_dict())
    with torch.inference_mode():
        d = dense.eval()(torch.from_numpy(pix), rng=JaxRng(key))
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  d["last_cluster_indices"].numpy())
    nc = int(d["num_clusters"].min())
    _close(got["last_hidden_state"], d["last_hidden_state"])
    _close(got["cluster_tokens"][:, :nc], d["cluster_tokens"][:, :nc])
    _close(got["receiver_to_transmitter_attentions"][:, :, :nc, :nc],
           d["receiver_to_transmitter_attentions"][:, :, :nc, :nc])


def test_banded_model_ignored_under_output_attentions():
    """Per-layer probabilities need the dense path: the banded flag is
    ignored and the attentions come out, as in JAX."""
    _, tcfg = _cfgs(banded_attention=True, pregeneration_period=1, generation_period=1)
    tmodel = tms.MultiStateViTEncoderModel(tcfg).eval()
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(_pixels(seed=3)), rng=0, output_attentions=True)
    assert out["intracluster_attentions"] is not None
    assert torch.isfinite(out["last_hidden_state"]).all()


def test_banded_segments_refuse_context_and_probabilities():
    """The attention layer raises rather than drop the cluster structure."""
    from msvit_tpu_torch.models.base.model import BaseViTSelfAttention

    _, tcfg = _cfgs()
    attn = BaseViTSelfAttention(tcfg, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 2 * 4 + 6, tcfg.hidden_size)
    seg = tband.BandedSegments(torch.zeros(1, 6, dtype=torch.long), torch.tensor(1), 4, 1e2)
    for kw in (dict(output_attentions=True), dict(context_states=x[:, :3])):
        with pytest.raises(ValueError, match="banded_segments"):
            attn(x, banded_segments=seg, **kw)


def test_quantized_banded_matches_jax():
    """`quantized_multistate_apply(attn_mode="banded")` against JAX's
    (kernels on: JAX's Pallas K10 in interpret mode), with clustering
    events: equal partitions, cosine >= 0.999 (the int8 bar of
    test_quantized_apply_matches_jax) for the hidden states, TX tokens and
    RX -> TX attentions."""
    jcfg, tcfg = _cfgs(pregeneration_period=1, generation_period=1)
    pix = _pixels(seed=0)
    _, variables, tmodel = _pair(jcfg, tcfg, pix)
    jq = jms.quantize_multistate_params(variables["params"])
    tq = tms.quantize_multistate_params(tmodel)
    key = jax.random.PRNGKey(9)
    js = jms.calibrate_multistate_act_scales(jq, jcfg, jnp.asarray(pix), key, use_kernels=False)
    want = jms.quantized_multistate_apply(jq, jcfg, jnp.asarray(pix), key, act_scales=js,
                                          use_kernels=True, attn_mode="banded")
    got = tms.quantized_multistate_apply(tq, tcfg, torch.from_numpy(pix), JaxRng(key),
                                         act_scales=act_scales_from_jax(js), use_kernels=True,
                                         attn_mode="banded")
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    for name in ("last_hidden_state", "cluster_tokens", "receiver_to_transmitter_attentions"):
        assert _cos(got[name], want[name]) >= 0.999, name
