"""PyTorch port on the card: each hand-written kernel against its plain
version on the same CUDA tensors, at small and odd shapes.  Marked `cuda`;
without a card every test skips (the decision is taken in a fixture, at
run time).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from msvit_tpu_torch.ops.packed_attention import (
    packed_attention,
    packed_attention_int8,
    packed_attention_int8_plain,
    packed_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, n, d, dtype, dev, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n, 3 * d, generator=g) * scale).to(dtype).to(dev)


# bf16: the kernel keeps p in f32 where the plain version rounds it to
# bf16 before P.V (the allowed deviation), so 2e-2 as in the CPU tests;
# f32: summation order and expf ulps only.
_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,dh", [(37, 4, 16), (197, 12, 64), (70, 2, 128),
                                    (5, 3, 8), (130, 2, 40)])
def test_k1_matches_plain(dev, dtype, n, h, dh):
    x = _qkv(3, n, h * dh, dtype, dev)
    before = packed_attention.launches
    with torch.inference_mode():
        got = packed_attention(x, h)
        want = packed_attention_plain(x, h)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= _TOL[dtype]


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("heads_in_mask", [1, 4])
def test_k1_masks_match_plain(dev, kind, heads_in_mask):
    b, n, h, dh = 2, 37, 4, 16
    x = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=1)
    g = torch.Generator().manual_seed(2)
    r = torch.rand(b, heads_in_mask, n, n, generator=g)
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False  # fully masked row: mean(V)
    else:
        m = -100.0 * (r < 0.3).float()
    m = m.to(dev)
    with torch.inference_mode():
        got = packed_attention(x, h, mask=m)
        want = packed_attention_plain(x, h, mask=m)
        bcast = packed_attention(x, h, mask=m[:1])  # [1, ...] broadcast
        want_b = packed_attention_plain(x, h, mask=m[:1])
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert (bcast.float() - want_b.float()).abs().max().item() <= 2e-2


def test_k1_large_logits_flatten_like_plain(dev):
    x = _qkv(2, 37, 64, torch.float32, dev, seed=3, scale=12.0)
    with torch.inference_mode():
        got = packed_attention(x, 4)
        want = packed_attention_plain(x, 4)
    assert (got - want).abs().max().item() <= 12 * 5e-5


def test_k1_refuses_grad_and_bad_inputs(dev):
    x = _qkv(1, 37, 64, torch.float32, dev).requires_grad_()
    with pytest.raises(NotImplementedError, match="training"):
        packed_attention(x, 4)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head size"):
            packed_attention(_qkv(1, 37, 4 * 12, torch.bfloat16, dev), 4)
        with pytest.raises(ValueError, match="contiguous"):
            packed_attention(_qkv(1, 37, 64, torch.bfloat16, dev)[:, ::2], 4)
        with pytest.raises(TypeError):
            packed_attention(_qkv(1, 37, 64, torch.float16, dev), 4)


def _int8(b, n, d, dev, seed):
    x = _qkv(b, n, d, torch.float32, dev, seed=seed, scale=0.5)
    sec = x.reshape(-1, 3, d).abs().amax(dim=(0, 2)) / 127.0
    q = torch.clamp(torch.round(x / sec.repeat_interleave(d)), -127, 127)
    return q.to(torch.int8), sec


@pytest.mark.parametrize("n,h,dh", [(37, 4, 16), (197, 12, 64), (70, 2, 128)])
def test_k3_matches_plain(dev, n, h, dh):
    q, sec = _int8(3, n, h * dh, dev, seed=4)
    with torch.inference_mode():
        got = packed_attention_int8(q, sec, h)
        want = packed_attention_int8_plain(q, sec, h)
        inv = 127.0 / want.float().abs().amax()
        got_q = packed_attention_int8(q, sec, h, out_inv_scale=inv, int8_out=True)
        want_q = packed_attention_int8_plain(q, sec, h, out_inv_scale=inv,
                                             int8_out=True)
    assert got.dtype == torch.bfloat16 and got_q.dtype == torch.int8
    # bf16 out: 2% of the output's range (a probability truncated one step
    # apart moves o by s_v/l)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    delta = (got_q.int() - want_q.int()).abs()
    assert delta.max().item() <= 1
    assert (delta == 0).float().mean().item() >= 0.99


@pytest.mark.parametrize("rows", [5, 16, 17, 197])
def test_int8_matmul_on_card_matches_cpu(dev, rows):
    """`torch._int_mm` on the card (rows <= 16 padded) against the CPU:
    the int32 products are exact, the f32 epilogue may differ by an ulp."""
    from msvit_tpu_torch.ops.quant import QuantizedTensor, int8_matmul, quantize_weight

    g = torch.Generator().manual_seed(6)
    x = torch.randn(rows, 64, generator=g)
    w = quantize_weight(torch.randn(40, 64, generator=g) * 0.05)
    bias = torch.randn(40, generator=g)
    want = int8_matmul(x, w, bias, out_dtype=torch.float32)
    wd = QuantizedTensor(w.values.to(dev), w.scale.to(dev))
    got = int8_matmul(x.to(dev), wd, bias.to(dev), out_dtype=torch.float32)
    assert got.shape == want.shape == (rows, 40)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
