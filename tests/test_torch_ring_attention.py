"""Ring attention of the port (`msvit_tpu_torch/parallel/ring_attention.py`)
on 4 gloo CPU ranks ("model" axis of 4) against dense attention computed by
the JAX package's test reference (`tests/test_ring_attention.py::_dense`):
the forward, a key-padding mask, the gradients, the indivisible-N error,
a padding tail that blanks a whole block, and bf16 inputs; and the ring's
per-block steps run in one process (`ring_attention_single_process`, what
the card check runs) against the port's dense flash attention.

On the CPU each block is K7-lse's and K6's plain version.  Bars: f32
1e-5 forward and 1e-4 gradients, as the JAX ring's own tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu_torch.ops.flash_attention import FlashAttentionFunction
from msvit_tpu_torch.parallel import launch
from msvit_tpu_torch.parallel.ring_attention import ring_attention_single_process

BODIES = "torch_parallel_bodies"


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, timeout=60, preload=(BODIES,)) as p:
        yield p


def _dense(q, k, v, mask=None):
    """`tests/test_ring_attention.py::_dense` (f32 softmax, -inf mask)."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        s = jnp.where(mask[:, None, None, :], s, -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


def _qkv(seed, b, n, h=2, dh=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, g, mask=None):
    out, vjp = jax.vjp(lambda *a: _dense(*a, mask=None if mask is None else jnp.asarray(mask)),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _check(r, out, grads, atol=1e-5, gtol=1e-4):
    np.testing.assert_allclose(r["out"], out, rtol=1e-5, atol=atol)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(r[name], want, rtol=1e-4, atol=gtol, err_msg=name)


def test_ring_matches_dense(pool):
    q, k, v, g = _qkv(0, 4, 16)
    out, grads = _jax(q, k, v, g)
    for r in pool.run(f"{BODIES}:ring", q=q, k=k, v=v, g=g):
        _check(r, out, grads)


def test_ring_with_key_padding_mask(pool):
    q, k, v, g = _qkv(1, 2, 24)
    mask = np.random.default_rng(1).random((2, 24)) < 0.7
    mask[:, 0] = True  # at least one attendable key
    out, grads = _jax(q, k, v, g, mask)
    for r in pool.run(f"{BODIES}:ring", q=q, k=k, v=v, g=g, mask=mask):
        _check(r, out, grads)


def test_ring_gradients_match_dense(pool):
    """The gradients of sum((out - tgt)^2), JAX's ring test's loss: its
    cotangent 2 (out - tgt) taken at the dense output."""
    q, k, v, tgt = _qkv(2, 2, 8)
    dense = np.asarray(_dense(*map(jnp.asarray, (q, k, v))))
    g = 2 * (dense - tgt)
    out, grads = _jax(q, k, v, g)
    for r in pool.run(f"{BODIES}:ring", q=q, k=k, v=v, g=g):
        _check(r, out, grads)


def test_ring_rejects_indivisible_tokens(pool):
    for msg in pool.run(f"{BODIES}:ring_indivisible"):
        assert "divisible" in msg


def test_ring_padding_tail_blanks_a_block(pool):
    """A padding tail that masks every key of the last rank's block (and,
    for image 1, of the last two): those blocks must add nothing to any
    query, in the forward and in the gradients (K7's finite mask value and
    its lse of such a block are not used as weights)."""
    q, k, v, g = _qkv(3, 2, 32)
    mask = np.ones((2, 32), bool)
    mask[0, 24:] = False
    mask[1, 16:] = False
    out, grads = _jax(q, k, v, g, mask)
    for r in pool.run(f"{BODIES}:ring", q=q, k=k, v=v, g=g, mask=mask):
        _check(r, out, grads)
        assert not r["dk"][0, 24:].any() and not r["dv"][1, 16:].any()


def test_ring_bf16_against_jax_f32(pool):
    """bf16 inputs (K7's tensor-core path on the card) against JAX's f32
    dense attention on the same bf16-rounded inputs: the output is rounded
    to bf16 (2^-8 relative) and each block's p too, so the bar is 2e-2
    absolute on outputs of size ~1 and 5e-2 on the gradients."""
    q, k, v, g = _qkv(4, 2, 16, h=2, dh=16)
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    out, grads = _jax(q, k, v, g)
    for r in pool.run(f"{BODIES}:ring", q=q, k=k, v=v, g=g, dtype="bfloat16"):
        _check(r, out, grads, atol=2e-2, gtol=5e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_single_process_ring_matches_flash(masked):
    """Every rank's ring in one process, 4 blocks in ring order, against
    the port's dense flash attention (`FlashAttentionFunction`, K7-lse and
    K6 on the whole sequence) with the same key mask (the last block
    blanked for image 0): forward 1e-5, gradients 1e-4."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(5, 2, 24, h=2, dh=8))
    mask = torch.ones(2, 24, dtype=torch.bool)
    if masked:
        mask[0, 18:] = False
        mask[1, 5] = False
    out, (dq, dk, dv) = ring_attention_single_process(q, k, v, 4, mask if masked else None, g)
    qt, kt, vt = (x.transpose(1, 2).clone().requires_grad_() for x in (q, k, v))
    want = FlashAttentionFunction.apply(qt, kt, vt, mask[:, None, None, :] if masked else None,
                                        8 ** -0.5, -0.7 * float(torch.finfo(torch.float32).max))
    (want * g.transpose(1, 2)).sum().backward()
    torch.testing.assert_close(out, want.transpose(1, 2), atol=1e-5, rtol=1e-5)
    for got, ref in ((dq, qt), (dk, kt), (dv, vt)):
        torch.testing.assert_close(got, ref.grad.transpose(1, 2), atol=1e-4, rtol=1e-4)
