"""PyTorch port on the card: each hand-written kernel against its plain
version on the same CUDA tensors, at small and odd shapes.  Marked `cuda`;
without a card every test skips (the decision is taken in a fixture, at
run time).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from msvit_tpu_torch.ops.packed_attention import (
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_plain,
    packed_attention_int8,
    packed_attention_int8_plain,
    packed_attention_lse,
    packed_attention_lse_plain,
    packed_attention_plain,
    kernel_route,
    route_counts,
    unpack_qkv,
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


# bf16: K1 rounds p to bf16 before P.V as the plain version does, but its
# exp2 and its f32 sums differ by ulps and can move a rounding by one bf16
# step; K1-lse rounds p against the running max where the plain version
# rounds it against the row's max: 2e-2 as in the CPU tests; f32: summation
# order and expf ulps only.
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


def _k1_case(x, h, mask=None):
    """K1 against its plain version (one launch); returns (got, want)."""
    before = packed_attention.launches
    with torch.inference_mode():
        got = packed_attention(x, h, mask=mask)
        want = packed_attention_plain(x, h, mask=mask)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == x.dtype
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _TOL[x.dtype]
    return got, want


@pytest.mark.parametrize("dh", [8, 24, 40, 64, 128])
@pytest.mark.parametrize("n", [63, 64, 65, 129, 785])
def test_k1_bf16_tile_edges(dev, dh, n):
    """The tensor-core K1 where its tiles have edges: N about a 64-row tile
    (and the pretrain's 785), head sizes zero-padded to 16, 32 and 64."""
    _k1_case(_qkv(2, n, 2 * dh, torch.bfloat16, dev, seed=60 + dh + n), 2)


def test_k1_bf16_fully_masked_row_is_mean_v(dev):
    """A fully masked bool row at N = 130 (a partial third tile): every real
    score clips to -80, the keys past N weigh exactly 0, so the row is
    mean(V) over the 130 real keys (not 130/192 of it)."""
    b, n, h, dh = 2, 130, 2, 40
    x = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=61)
    m = torch.rand(b, 1, n, n, generator=torch.Generator().manual_seed(62)) < 0.7
    m[:, :, 7, :] = False
    m[:, :, 129, :] = False
    got, _ = _k1_case(x, h, m.to(dev))
    mean_v = x[..., 2 * h * dh:].float().mean(1)  # [B, D]
    for row in (7, 129):
        assert (got[:, row].float() - mean_v).abs().max().item() <= _TOL[torch.bfloat16]


@pytest.mark.parametrize("n,h,dh", [(37, 4, 16), (197, 12, 64), (130, 2, 128)])
def test_k1_bf16_large_logits_flatten_like_plain(dev, n, h, dh):
    """q and k x 12 in bf16 (|s| in the hundreds): the clip at +-80 flattens
    the rows, in the kernel as in the plain version."""
    x = _qkv(2, n, h * dh, torch.bfloat16, dev, seed=63).float()
    x[..., : 2 * h * dh] *= 12.0
    x = x.to(torch.bfloat16)
    q, k = x[..., : h * dh].float(), x[..., h * dh : 2 * h * dh].float()
    s = torch.einsum("bnhd,bmhd->bhnm", q.reshape(2, n, h, dh), k.reshape(2, n, h, dh))
    assert (s * dh**-0.5).abs().max().item() > 150
    _k1_case(x, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_deterministic(dev, dtype, masked):
    """No atomics: two calls of K1 give the same bits."""
    b, n, h, dh = 2, 197, 12, 64
    x = _qkv(b, n, h * dh, dtype, dev, seed=64)
    m = _grouped_mask("additive" if masked else None, b, h, n, dev, seed=65)
    with torch.inference_mode():
        o1, o2 = (packed_attention(x, h, mask=m) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


def test_k1_refuses_grad_and_bad_inputs(dev):
    """A CUDA input that requires grad goes through PackedAttentionFunction:
    K1-lse forward, K2 backward (one launch each), the gradient equal to
    K2's plain version on the same residuals; bad inputs still raise."""
    x = _qkv(1, 37, 64, torch.float32, dev).requires_grad_()
    g = _qkv(1, 37, 64, torch.float32, dev, seed=9)[..., :64].contiguous()
    n1, n2, n0 = (packed_attention_lse.launches, packed_attention_bwd.launches,
                  packed_attention.launches)
    out = packed_attention(x, 4)
    out.backward(g)
    torch.cuda.synchronize()
    assert packed_attention_lse.launches == n1 + 1
    assert packed_attention_bwd.launches == n2 + 1
    assert packed_attention.launches == n0
    with torch.no_grad():
        o, lse = packed_attention_lse_plain(x, 4)
        want = packed_attention_bwd_plain(x, None, o, lse, g, 4)
    assert (x.grad - want).abs().max().item() <= _bwd_tol(torch.float32, want)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head size"):
            packed_attention(_qkv(1, 37, 4 * 12, torch.bfloat16, dev), 4)
        with pytest.raises(ValueError, match="contiguous"):
            packed_attention(_qkv(1, 37, 64, torch.bfloat16, dev)[:, ::2], 4)
        with pytest.raises(TypeError):
            packed_attention(_qkv(1, 37, 64, torch.float16, dev), 4)
    with pytest.raises(ValueError, match="head size"):
        packed_attention_lse(_qkv(1, 37, 4 * 12, torch.bfloat16, dev), 4)
    with pytest.raises(ValueError, match="lse"):
        xb = _qkv(1, 37, 64, torch.bfloat16, dev)
        packed_attention_bwd(xb, None, xb[..., :64].contiguous(),
                             torch.zeros(1, 4, 36, device=dev),
                             xb[..., :64].contiguous(), 4)


# K1-lse: out as K1; lse is f32 from f32 scores in another summation order
# (bf16: the tensor cores' f32 accumulators): 1e-5 of its size.
def _lse_err(got, want):
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


# K2: the kernel mirrors the bf16 roundings of pb and ds, but its f32 sums
# run in another order and can move a rounding by one bf16 step; bf16 3e-2
# (the JAX package's bar for its backward), f32 1e-4, each of max |dqkv|.
def _bwd_tol(dtype, want):
    base = 3e-2 if dtype == torch.bfloat16 else 1e-4
    return base * max(1.0, want.float().abs().max().item())


def _train_case(b, n, h, dh, dtype, dev, seed, mask=None, scale=1.0):
    """Kernel vs plain for K1-lse (out, lse) and K2 (dqkv, from the plain
    forward's residuals and a random cotangent)."""
    x = _qkv(b, n, h * dh, dtype, dev, seed=seed)
    if scale != 1.0:
        x[..., : 2 * h * dh] *= scale
    g = _qkv(b, n, h * dh, dtype, dev, seed=seed + 1)[..., : h * dh].contiguous()
    n1, n2 = packed_attention_lse.launches, packed_attention_bwd.launches
    routes = route_counts()
    with torch.no_grad():
        o, lse = packed_attention_lse(x, h, mask=mask)
        wo, wl = packed_attention_lse_plain(x, h, mask=mask)
        got = packed_attention_bwd(x, mask, wo, wl, g, h)
        want = packed_attention_bwd_plain(x, mask, wo, wl, g, h)
    torch.cuda.synchronize()
    assert (packed_attention_lse.launches, packed_attention_bwd.launches) == (n1 + 1, n2 + 1)
    # each launch took its route: wgmma for bf16 at head size 64
    route = kernel_route(dtype, dh)
    now = route_counts()
    for k in ("K1-lse", "K2"):
        assert {r: c - routes[k][r] for r, c in now[k].items()} == {
            r: int(r == route) for r in now[k]}, k
    assert o.dtype == dtype and lse.dtype == torch.float32 and got.dtype == dtype
    assert torch.isfinite(o).all() and torch.isfinite(got).all()
    assert (o.float() - wo.float()).abs().max().item() <= _TOL[dtype]
    assert _lse_err(lse, wl) <= 1e-5
    assert (got.float() - want.float()).abs().max().item() <= _bwd_tol(dtype, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,dh", [(37, 4, 16), (197, 12, 64), (70, 2, 128),
                                    (5, 3, 8)])
def test_k1_lse_and_k2_match_plain(dev, dtype, n, h, dh):
    _train_case(2, n, h, dh, dtype, dev, seed=20)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("heads_in_mask", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_lse_and_k2_masks_match_plain(dev, kind, heads_in_mask, dtype):
    b, n, h, dh = 2, 37, 4, 16
    r = torch.rand(b, heads_in_mask, n, n, generator=torch.Generator().manual_seed(21))
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False  # fully masked row: mean(V), lse = mask_value + log N
    else:
        m = -100.0 * (r < 0.3).float()
    _train_case(b, n, h, dh, dtype, dev, seed=22, mask=m.to(dev))
    _train_case(b, n, h, dh, dtype, dev, seed=23, mask=m[:1].to(dev))  # broadcast


def test_k1_lse_and_k2_large_logits(dev):
    """q and k scaled by 12 (|s| in the hundreds): exact, finite, equal to
    the plain versions."""
    _train_case(2, 37, 4, 16, torch.float32, dev, seed=24, scale=12.0)
    _train_case(2, 197, 12, 64, torch.float32, dev, seed=25, scale=12.0)


# ------------------------------ K1-lse and K2 on the tensor cores (bf16) ----
# bf16 runs mma.sync tiles of 64 rows by 64 keys (or queries), the head
# zero-padded to 16/32/64/128 in shared memory: the cases below sit on and
# around the tile edges and the padded head sizes.


@pytest.mark.parametrize("dh", [8, 24, 40, 64, 128])
@pytest.mark.parametrize("n", [5, 63, 64, 65, 197])
def test_k1_lse_and_k2_bf16_tile_edges(dev, dh, n):
    _train_case(2, n, 2, dh, torch.bfloat16, dev, seed=26 + dh + n)


def test_k1_lse_and_k2_bf16_pretrain_shape(dev):
    """Two images of the ViT-B/8 pretrain's [B, 785, 2304]."""
    _train_case(2, 785, 12, 64, torch.bfloat16, dev, seed=27)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("heads_in_mask", [1, 2])
def test_k1_lse_and_k2_bf16_masks_at_tile_edges(dev, kind, heads_in_mask):
    """Masks at N = 130 (a partial third tile), dh 40 (padded to 64): a
    fully masked bool row, additive per head and broadcast."""
    b, n, h, dh = 2, 130, 2, 40
    r = torch.rand(b, heads_in_mask, n, n, generator=torch.Generator().manual_seed(28))
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False  # fully masked rows: mean(V), lse = mask_value + log N
        m[:, :, 129, :] = False
    else:
        m = -100.0 * (r < 0.3).float()
    _train_case(b, n, h, dh, torch.bfloat16, dev, seed=29, mask=m.to(dev))
    _train_case(b, n, h, dh, torch.bfloat16, dev, seed=30, mask=m[:1].to(dev))


@pytest.mark.parametrize("n,h,dh", [(37, 4, 16), (197, 12, 64), (70, 2, 128)])
def test_k1_lse_and_k2_bf16_large_logits(dev, n, h, dh):
    """q and k scaled by 12 (|s| in the hundreds) in bf16: exact, finite,
    equal to the plain versions."""
    _train_case(2, n, h, dh, torch.bfloat16, dev, seed=31, scale=12.0)


# --------------------- K1-lse and K2 on wgmma fed by TMA (bf16, dh 64) ----
# 128-row blocks of two 64-row warpgroups, 64-key (or 64-query) tiles from
# a 3-D TMA map over the packed tensors: the cases sit on and around both
# tile edges, with every mask form, a fully masked row, an all -inf row and
# large logits; `_train_case` checks that each launch took the wgmma route.


@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 197, 785])
def test_wgmma_route_tile_edges(dev, n):
    _train_case(2, n, 2, 64, torch.bfloat16, dev, seed=50 + n)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("heads_in_mask", [1, 3])
@pytest.mark.parametrize("n", [65, 197])
def test_wgmma_route_masks(dev, kind, heads_in_mask, n):
    """Per-head and broadcast masks; the bool one with fully masked rows
    (mean(V), lse = mask_value + log N) on both sides of a tile edge."""
    b, h = 2, 3
    r = torch.rand(b, heads_in_mask, n, n, generator=torch.Generator().manual_seed(60 + n))
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False
        m[:, :, 64, :] = False
    else:
        m = -100.0 * (r < 0.3).float()
    _train_case(b, n, h, 64, torch.bfloat16, dev, seed=61, mask=m.to(dev))
    _train_case(b, n, h, 64, torch.bfloat16, dev, seed=62, mask=m[:1].to(dev))


def test_wgmma_route_all_minus_inf_row(dev):
    """An additive mask whose row is all -inf gives NaN there (out and the
    row's dq), as the plain versions do; every other element agrees."""
    b, n, h, dh = 2, 130, 2, 64
    m = torch.zeros(b, 1, n, n)
    m[1, 0, 70, :] = -float("inf")
    m = m.to(dev)
    x = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=63)
    g = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=64)[..., : h * dh].contiguous()
    with torch.no_grad():
        o, lse = packed_attention_lse(x, h, mask=m)
        wo, wl = packed_attention_lse_plain(x, h, mask=m)
        got = packed_attention_bwd(x, m, wo, wl, g, h)
        want = packed_attention_bwd_plain(x, m, wo, wl, g, h)
    torch.cuda.synchronize()
    for a, w in ((o, wo), (got, want)):
        assert torch.equal(a.isnan(), w.isnan()) and a[1, 70].isnan().any()
        assert (a.float() - w.float()).nan_to_num(0.0).abs().max().item() <= _bwd_tol(
            torch.bfloat16, w.nan_to_num(0.0))
    assert _lse_err(lse[0], wl[0]) <= 1e-5


@pytest.mark.parametrize("n", [197, 785])
def test_wgmma_route_large_logits(dev, n):
    """q and k scaled by 12 (|s| in the hundreds) in bf16."""
    _train_case(2, n, 2, 64, torch.bfloat16, dev, seed=65, scale=12.0)


@pytest.mark.parametrize("masked", [None, "bool", "additive"])
def test_wgmma_route_deterministic(dev, masked):
    """No atomics: two calls of each wgmma kernel give the same bits."""
    b, n, h, dh = 2, 197, 3, 64
    x = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=66)
    g = _qkv(b, n, h * dh, torch.bfloat16, dev, seed=67)[..., : h * dh].contiguous()
    m = _grouped_mask(masked, b, h, n, dev, seed=68)
    with torch.no_grad():
        (o1, l1), (o2, l2) = (packed_attention_lse(x, h, mask=m) for _ in range(2))
        d1, d2 = (packed_attention_bwd(x, m, o1, l1, g, h) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2) and torch.equal(d1, d2)


@pytest.mark.parametrize("dh", [32, 80, 128])
def test_other_head_sizes_take_mma_sync(dev, dh):
    """dh 32, 80 (vit-h14) and 128 stay on the mma.sync kernels: the route
    counters say so."""
    _train_case(2, 130, 2, dh, torch.bfloat16, dev, seed=69 + dh)
    assert kernel_route(torch.bfloat16, dh) == "mma.sync"


def test_wgmma_route_refuses_a_misaligned_qkv(dev):
    """A qkv whose base is off 16 bytes raises; it takes no other route."""
    x = torch.zeros(1 + 2 * 5 * 192, dtype=torch.bfloat16, device=dev)[1:].view(2, 5, 192)
    with pytest.raises(ValueError, match="aligned"):
        packed_attention_lse(x, 1)


# ------------------------ K1, K7 and K7-lse on wgmma fed by TMA (bf16, dh 64) ----
# The same 128-row blocks over 4-D TMA maps of [B, H, N, 64] views (K1:
# the packed qkv's; K7: strided or contiguous q/k/v, Nq != Nk), the mask
# loaded straight into the accumulators' layout: the cases sit on and
# around the tile edges, at the main path's lengths (197, 785, 1370; 3168
# and the key-only 1361), with every mask form; each launch's route is read
# from the route counters.


def _took(before: dict, want: dict) -> None:
    """Since `before` (a `route_counts()`), each kernel named in `want`
    launched once, on that route, and no other routed kernel launched."""
    now = route_counts()
    for k, counts in now.items():
        got = {r: c - before[k][r] for r, c in counts.items()}
        assert got == {r: int(r == want.get(k)) for r in counts}, (k, got)


def _k1_wgmma_case(x, h, mask=None):
    """K1 against its plain version, one launch on the wgmma route."""
    before = route_counts()
    with torch.inference_mode():
        got = packed_attention(x, h, mask=mask)
        want = packed_attention_plain(x, h, mask=mask)
    torch.cuda.synchronize()
    _took(before, {"K1": "wgmma"})
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _TOL[torch.bfloat16]
    return got


@pytest.mark.parametrize("n", [5, 63, 64, 65, 127, 128, 129, 197, 785, 1370])
def test_k1_wgmma_tile_edges(dev, n):
    _k1_wgmma_case(_qkv(2, n, 2 * 64, torch.bfloat16, dev, seed=80 + n), 2)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("heads_in_mask", [1, 3])
@pytest.mark.parametrize("n", [65, 197])
def test_k1_wgmma_masks(dev, kind, heads_in_mask, n):
    """Per-head and broadcast masks; the bool one with fully masked rows on
    both sides of a tile edge, each mean(V) over the N real keys."""
    b, h = 2, 3
    x = _qkv(b, n, h * 64, torch.bfloat16, dev, seed=81)
    r = torch.rand(b, heads_in_mask, n, n, generator=torch.Generator().manual_seed(82 + n))
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False
        m[:, :, 64, :] = False
    else:
        m = -100.0 * (r < 0.3).float()
    m = m.to(dev)
    for mask in (m, m[:1]):  # per image, and broadcast over the images
        got = _k1_wgmma_case(x, h, mask)
    if kind == "bool":
        mean_v = x[..., 2 * h * 64:].float().mean(1)  # [B, D]
        for row in (0, 64):
            assert (got[:, row].float() - mean_v).abs().max().item() <= _TOL[torch.bfloat16]


@pytest.mark.parametrize("n", [197, 785])
def test_k1_wgmma_large_logits_flatten_like_plain(dev, n):
    """q and k x 12 in bf16 (|s| in the hundreds): the clip at +-80
    flattens the rows, in the kernel as in the plain version."""
    h = 2
    x = _qkv(2, n, h * 64, torch.bfloat16, dev, seed=83).float()
    x[..., : 2 * h * 64] *= 12.0
    x = x.to(torch.bfloat16)
    q, k, _ = (t.float() for t in unpack_qkv(x, h))
    assert (torch.matmul(q, k.transpose(-1, -2)) * 0.125).abs().max().item() > 150
    _k1_wgmma_case(x, h)


@pytest.mark.parametrize("masked", [None, "bool", "additive"])
def test_k1_wgmma_deterministic(dev, masked):
    """No atomics: two calls give the same bits."""
    b, n, h = 2, 197, 12
    x = _qkv(b, n, h * 64, torch.bfloat16, dev, seed=84)
    m = _grouped_mask(masked, b, h, n, dev, seed=85)
    with torch.inference_mode():
        o1, o2 = (packed_attention(x, h, mask=m) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


def test_k1_wgmma_refuses_a_misaligned_qkv(dev):
    """A qkv whose base is off 16 bytes raises; it takes no other route."""
    x = torch.zeros(1 + 2 * 5 * 192, dtype=torch.bfloat16, device=dev)[1:].view(2, 5, 192)
    before = route_counts()
    with torch.inference_mode(), pytest.raises(ValueError, match="packed_attention"):
        packed_attention(x, 1)
    _took(before, {})


def _k7_wgmma_case(q, k, v, mask=None, route="wgmma"):
    """K7 and K7-lse against their plain version, one launch each on
    `route`; K7's out is K7-lse's.  Returns (out, lse, plain out, plain
    lse)."""
    from msvit_tpu_torch.ops import flash_attention as fl

    before = route_counts()
    with torch.inference_mode():
        got = fl.flash_attention(q, k, v, mask=mask)
        o, lse = fl.flash_attention_lse(q, k, v, mask=mask)
        want, wl = fl.flash_attention_lse_plain(q, k, v, mask=mask)
    torch.cuda.synchronize()
    _took(before, {"K7": route, "K7-lse": route})
    assert got.shape == want.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    assert torch.equal(got, o)
    tol = _TOL[q.dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _lse_err(lse, wl) <= 1e-5
    return got, lse, want, wl


@pytest.mark.parametrize("b,nq,nk,h,mask,packed", [
    (1, 3168, 3168, 2, "additive", True),  # the 448-px trunk's soft mask, broadcast
    (2, 197, 3168, 2, "additive", True),  # Nq != Nk, as the CPU tests take
    (2, 3168, 197, 2, "bool_per_head", False),  # Q longer than K/V
    (2, 63, 65, 3, "bool", True),
    (2, 129, 127, 3, "additive_per_head", False),
    (2, 128, 64, 2, None, True),
    (2, 5, 9, 2, "bool_per_head", False),
    (2, 600, 1100, 2, None, False),
])
def test_k7_wgmma_shapes(dev, b, nq, nk, h, mask, packed):
    """Strided views of packed QKV outputs or contiguous tensors, every mask
    form; a bool mask's row 0 is fully masked: mean(V)."""
    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=86, packed=packed)
    m = _fused_mask(mask, b, h, nq, nk, dev, seed=87)
    got, _, want, _ = _k7_wgmma_case(q, k, v, m)
    if mask is not None and mask.startswith("bool"):
        tol = _TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("nq", [1025, 1361])
def test_k7_wgmma_key_only_masks(dev, kind, nq):
    """The depth-3 subsample trunk's key-only masks ([B, 1, 1, 1361]: one
    row at pitch 0, 1361-entry rows off every alignment): bit-equal to the
    mask expanded in memory."""
    q, k, v = _heads(2, nq, 1361, 2, 64, torch.bfloat16, dev, seed=88, packed=True)
    m = _key_mask(kind, 2, 1361, dev, seed=89)
    got, lse, _, _ = _k7_wgmma_case(q, k, v, m)
    full, full_lse, _, _ = _k7_wgmma_case(q, k, v, m.expand(-1, -1, nq, -1).contiguous())
    assert torch.equal(got, full) and torch.equal(lse, full_lse)


def test_k7_wgmma_zero_l_row_and_fully_masked_row(dev):
    """At Nq 197 x Nk 3168: an additive row of -inf has l == 0 and gives
    zeros and lse 0 (K7's guard, where K1-lse gives NaN); a fully masked
    bool row gives mean(V) and lse = mask_value + log Nk."""
    from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE

    b, nq, nk, h = 2, 197, 3168, 2
    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=90, packed=True)
    m = -100.0 * (torch.rand(b, 1, nq, nk, generator=torch.Generator().manual_seed(91))
                  < 0.3).float()
    m[1, 0, 3] = -torch.inf
    got, lse, _, _ = _k7_wgmma_case(q, k, v, m.to(dev))
    assert torch.equal(got[1, :, 3], torch.zeros_like(got[1, :, 3]))
    assert torch.equal(lse[1, :, 3], torch.zeros_like(lse[1, :, 3]))
    mb = torch.rand(b, h, nq, nk, generator=torch.Generator().manual_seed(92)) < 0.7
    mb[:, :, 130] = False
    got, lse, want, _ = _k7_wgmma_case(q, k, v, mb.to(dev))
    tol = _TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    assert (got[:, :, 130].float() - v.float().mean(2)).abs().max().item() <= tol
    full = torch.full_like(lse[:, :, 130], DEFAULT_MASK_VALUE + math.log(nk))
    assert _lse_err(lse[:, :, 130], full) <= 1e-5


def test_k7_wgmma_large_logits_are_exact(dev):
    """q and k x 12 (|s| in the hundreds): the online max keeps every row
    exact, as the plain version."""
    q, k, v = _heads(2, 197, 300, 2, 64, torch.float32, dev, seed=93, packed=True)
    _k7_wgmma_case((q * 12).to(torch.bfloat16), (k * 12).to(torch.bfloat16),
                   v.to(torch.bfloat16))


def test_k7_wgmma_refuses_a_view_tma_cannot_map(dev):
    """A q view whose row pitch is 136 bytes (not a multiple of 16) raises
    on the wgmma route, naming the wrapper; nothing launches, nothing is
    copied to another route."""
    from msvit_tpu_torch.ops import flash_attention as fl

    base = torch.zeros(2, 70, 68, dtype=torch.bfloat16, device=dev)
    q = base[..., :64].unsqueeze(1)  # [2, 1, 70, 64], rows 68 elements apart
    k = v = torch.zeros(2, 1, 70, 64, dtype=torch.bfloat16, device=dev)
    before = route_counts()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="flash_attention: TMA"):
            fl.flash_attention(q, k, v)
        with pytest.raises(ValueError, match="flash_attention_lse: TMA"):
            fl.flash_attention_lse(q, k, v)
    _took(before, {})


@pytest.mark.parametrize("dh", [32, 128])
def test_k1_and_k7_other_head_sizes_take_mma_sync(dev, dh):
    """Head sizes other than 64 stay on the mma.sync kernels, f32 on the
    CUDA cores: the route counters say so."""
    before = route_counts()
    x = _qkv(2, 130, 2 * dh, torch.bfloat16, dev, seed=94)
    with torch.inference_mode():
        got = packed_attention(x, 2)
    torch.cuda.synchronize()
    _took(before, {"K1": "mma.sync"})
    assert (got.float() - packed_attention_plain(x, 2).float()).abs().max().item() <= _TOL[
        torch.bfloat16]
    q, k, v = _heads(2, 130, 150, 2, dh, torch.bfloat16, dev, seed=95, packed=True)
    _k7_wgmma_case(q, k, v, route="mma.sync")
    q, k, v = _heads(2, 130, 150, 2, 64, torch.float32, dev, seed=96, packed=True)
    _k7_wgmma_case(q, k, v, route="cuda_cores")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_lse_and_k2_deterministic(dev, dtype, masked):
    """No atomics: two calls of each kernel give the same bits."""
    b, n, h, dh = 2, 197, 12, 64
    x = _qkv(b, n, h * dh, dtype, dev, seed=32)
    g = _qkv(b, n, h * dh, dtype, dev, seed=33)[..., : h * dh].contiguous()
    m = _grouped_mask("additive" if masked else None, b, h, n, dev, seed=34)
    with torch.no_grad():
        (o1, l1), (o2, l2) = (packed_attention_lse(x, h, mask=m) for _ in range(2))
        d1, d2 = (packed_attention_bwd(x, m, o1, l1, g, h) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2) and torch.equal(d1, d2)


def _int8(b, n, d, dev, seed):
    x = _qkv(b, n, d, torch.float32, dev, seed=seed, scale=0.5)
    sec = x.reshape(-1, 3, d).abs().amax(dim=(0, 2)) / 127.0
    q = torch.clamp(torch.round(x / sec.repeat_interleave(d)), -127, 127)
    return q.to(torch.int8), sec


# the int8 kernels' tile edges: N around the 16-row warp tiles and the
# 32-key k-steps and 64-key tiles, 197 (ViT-B/16) and 257; head sizes that
# pad to the 32-byte k-depth (8, 16, 24, 40) and whose slices are only
# 8-byte aligned (8, 24, 40)
_INT8_EDGE_NS = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 197, 257]
_INT8_EDGE_DHS = [8, 16, 24, 40, 64, 128]
_INT8_SHAPES = [(37, 4, 16), (197, 12, 64), (70, 2, 128)] + [
    (n, 2, dh) for n in _INT8_EDGE_NS for dh in _INT8_EDGE_DHS]


def _int8_bars(got, want, got_q, want_q):
    """bf16 out: 2% of the output's range (a probability truncated one step
    apart moves o by s_v/l); int8 out: |delta| <= 1 step with >= 99% equal
    (an exp within an ulp of an integer truncates one step apart)."""
    assert got.dtype == torch.bfloat16 and got_q.dtype == torch.int8
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    delta = (got_q.int() - want_q.int()).abs()
    assert delta.max().item() <= 1
    assert (delta == 0).float().mean().item() >= 0.99


@pytest.mark.parametrize("n,h,dh", _INT8_SHAPES)
def test_k3_matches_plain(dev, n, h, dh):
    """K3 on the int8 tensor cores against its plain version, bf16 and int8
    out, at the tile edges too."""
    q, sec = _int8(3, n, h * dh, dev, seed=4)
    before = packed_attention_int8.launches
    with torch.inference_mode():
        got = packed_attention_int8(q, sec, h)
        want = packed_attention_int8_plain(q, sec, h)
        inv = 127.0 / want.float().abs().amax()
        got_q = packed_attention_int8(q, sec, h, out_inv_scale=inv, int8_out=True)
        want_q = packed_attention_int8_plain(q, sec, h, out_inv_scale=inv,
                                             int8_out=True)
    torch.cuda.synchronize()
    assert packed_attention_int8.launches == before + 2
    _int8_bars(got, want, got_q, want_q)


def _fused_fns(kernel):
    from msvit_tpu_torch.ops import fused_attention as fa

    if kernel == "K5":
        return fa.fused_attention, fa.fused_attention_plain
    return fa.fused_attention_inference, fa.fused_attention_inference_plain


def _heads(b, nq, nk, h, dh, dtype, dev, seed, packed):
    """q [B, H, Nq, dh], k, v [B, H, Nk, dh]: views of packed [B, N, 3D]
    GEMM outputs (strided, the model's layout) or contiguous tensors."""
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    if packed:
        q = unpack_qkv(_qkv(b, nq, h * dh, dtype, dev, seed=seed), h)[0]
        _, k, v = unpack_qkv(_qkv(b, nk, h * dh, dtype, dev, seed=seed + 1), h)
        return q, k, v
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, n, dh, generator=g).to(dtype).to(dev)
                 for n in (nq, nk, nk))


def _fused_mask(kind, b, h, nq, nk, dev, seed):
    g = torch.Generator().manual_seed(seed)
    if kind is None:
        return None
    if kind.startswith("bool"):
        m = torch.rand(b, h if kind == "bool_per_head" else 1, nq, nk, generator=g) < 0.7
        m[:, :, 0, :] = False  # a fully masked row: mean(V)
        return m.to(dev)
    # additive: the multistate soft penalty on ~30% of the entries
    hm = h if kind == "additive_per_head" else 1
    return (-100.0 * (torch.rand(b, hm, nq, nk, generator=g) < 0.3).float()).to(dev)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,h,dh,mask,packed", [
    (37, 37, 4, 16, None, False),
    (70, 70, 2, 32, "bool_per_head", True),
    (130, 130, 3, 64, "additive", True),
    (65, 200, 2, 128, "additive_per_head", False),  # K/V longer than Q
    (197, 816, 2, 64, "bool", True),  # cross-context at the bench kv length
    (5, 9, 3, 8, "bool_per_head", False),
    (100, 30, 2, 40, "additive", False),  # Q longer than K/V
])
def test_k4_k5_match_plain(dev, kernel, dtype, nq, nk, h, dh, mask, packed):
    """K4 and K5 against their plain versions at odd shapes (N not a
    multiple of 64, head sizes 8-128, Nq != Nk), every mask kind, q/k/v
    strided views of the QKV GEMM output or contiguous.  Tolerances as K1
    (both round p to bf16 into P.V; K5 against the running max, its plain
    version against the row's max), of max(1, max |plain|): a row attending
    few keys has an output near a single value of V, where one bf16 step is
    2^-8 of it."""
    fn, plain = _fused_fns(kernel)
    q, k, v = _heads(2, nq, nk, h, dh, dtype, dev, seed=30, packed=packed)
    m = _fused_mask(mask, 2, h, nq, nk, dev, seed=31)
    before = fn.launches
    with torch.inference_mode():
        got = fn(q, k, v, mask=m)
        want = plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (2, h, nq, dh) and got.dtype == dtype
    assert torch.isfinite(got).all()
    tol = _TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    if mask is not None and mask.startswith("bool"):  # row 0: mean(V)
        mean_v = v.float().mean(2)
        assert (got[:, :, 0].float() - mean_v).abs().max().item() <= tol


def test_k5_large_logits_and_minus_inf_rows(dev):
    """K5 is exact at any logit scale (q and k x 12: |s| in the hundreds);
    an additive -inf row gives zeros, as the TPU kernel's l == 0 guard."""
    q, k, v = _heads(2, 70, 90, 2, 64, torch.float32, dev, seed=32, packed=False)
    m = torch.zeros(2, 1, 70, 90, device=dev)
    m[1, 0, 3] = -torch.inf
    fn, plain = _fused_fns("K5")
    with torch.inference_mode():
        got = fn(q * 12, k * 12, v, mask=m)
        want = plain(q * 12, k * 12, v, mask=m)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, :, 3], torch.zeros_like(got[1, :, 3]))
    assert (got - want).abs().max().item() <= 1e-4


def test_fused_kernels_refuse_grad_and_bad_inputs(dev):
    """Under autograd on the card K5 runs FusedAttentionFunction (K5-lse
    forward, K6 backward: one launch each, no K5 launch), while the
    serving-only K4 still raises instead of running a plain version;
    unsupported inputs raise."""
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd

    fn5, _ = _fused_fns("K5")
    fn4, _ = _fused_fns("K4")
    q, k, v = _heads(1, 37, 37, 2, 16, torch.float32, dev, seed=33, packed=False)
    qg = q.clone().requires_grad_()
    n5, n4 = fn5.launches, fn4.launches
    nl, nb = fa.fused_attention_lse.launches, flash_attention_bwd.launches
    fn5(qg, k, v).sum().backward()
    torch.cuda.synchronize()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    assert (fa.fused_attention_lse.launches, flash_attention_bwd.launches) == (nl + 1, nb + 1)
    with pytest.raises(NotImplementedError, match="serving-only"):
        fn4(qg, k, v)
    assert (fn5.launches, fn4.launches) == (n5, n4)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head size"):
            fn5(q[..., :12], k[..., :12], v[..., :12])
        with pytest.raises(TypeError):
            fn5(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="mask"):
            fn4(q, k, v, mask=torch.ones(1, 1, 37, 36, dtype=torch.bool, device=dev))
        with pytest.raises(ValueError, match="lse"):
            flash_attention_bwd(q, k, v, q, q, torch.zeros(1, 2, 36, device=dev))


@pytest.mark.parametrize("kernel", ["K4", "K5", "K5-lse"])
def test_k4_k5_round_p_like_plain(dev, kernel):
    """K4, K5 and K5-lse round p to bf16 into P.V, as the TPU kernels and
    the plain versions do (l from the unrounded p).  The scores come from an
    additive mask (q = 0) with key 0 the row's max, so that K5's running max
    is the row's max from the first key on and both sides round the same p:
    the kernel's bf16 output equals the plain version's on >= 99% of the
    elements, and the same arithmetic with p kept in f32 equals it on at
    most 90% (about 68% at these inputs); errors within the K1 bar."""
    from msvit_tpu_torch.ops import fused_attention as fa

    b, h, nq, nk, dh = 2, 2, 64, 9, 64
    gen = torch.Generator().manual_seed(74)
    q = torch.zeros(b, h, nq, dh)
    k, v = (torch.randn(b, h, nk, dh, generator=gen) for _ in range(2))
    m = -(torch.rand(b, 1, nq, nk, generator=gen) * 3 + 0.01)
    m[..., 0] = 0.0
    q, k, v = (t.to(torch.bfloat16).to(dev) for t in (q, k, v))
    m = m.to(dev)
    fn = {"K4": fa.fused_attention_inference, "K5": fa.fused_attention,
          "K5-lse": lambda *a, **kw: fa.fused_attention_lse(*a, **kw)[0]}[kernel]
    plain = fa.fused_attention_inference_plain if kernel == "K4" else fa.fused_attention_plain
    with torch.inference_mode():
        got = fn(q, k, v, mask=m)
        want = plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    p = torch.exp(m.expand(b, h, nq, nk))  # s = the mask; its max is 0
    unrounded = (torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    tol = _TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got == want).float().mean().item() >= 0.99
    assert (got == unrounded).float().mean().item() <= 0.9


def _fused_case(kernel, q, k, v, m):
    """One call of K4, K5 or K5-lse (one launch: bf16 on wgmma at head size
    64 and on mma.sync at the others, f32 on the CUDA cores) against its plain version:
    out within the K1 bar of max(1, max |plain|), K5-lse's lse within 1e-5
    of max(1, |lse|) and its out K5's bits.  Returns the kernel's out and
    the bar."""
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops.packed_attention import routes_of

    fn = {"K4": fa.fused_attention_inference, "K5": fa.fused_attention,
          "K5-lse": fa.fused_attention_lse}[kernel]
    before, routes = fn.launches, routes_of(fn)
    with torch.inference_mode():
        if kernel == "K5-lse":
            got, lse = fn(q, k, v, mask=m)
            want, wl = fa.fused_attention_lse_plain(q, k, v, mask=m)
            out5 = fa.fused_attention(q, k, v, mask=m)
        else:
            got = fn(q, k, v, mask=m)
            plain = (fa.fused_attention_inference_plain if kernel == "K4"
                     else fa.fused_attention_plain)
            want = plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    route = kernel_route(q.dtype, q.shape[-1])
    assert {r: c - routes[r] for r, c in routes_of(fn).items()} == {
        r: int(r == route) for r in routes}
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all()
    tol = _TOL[q.dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    if kernel == "K5-lse":
        assert torch.isfinite(lse).all() and _lse_err(lse, wl) <= 1e-5
        assert torch.equal(got, out5)
    return got, tol


_EDGE_NS = [63, 64, 65, 127, 816]
_EDGE_DHS = [8, 16, 40, 64, 128]
# the other side of each N's cross case: Nq != Nk both ways
_EDGE_NK = {63: 129, 64: 65, 65: 64, 127: 63, 816: 197}
_EDGE_MASKS = ["bool", "bool_per_head", "additive", "additive_per_head"]


@pytest.mark.parametrize("dh", _EDGE_DHS)
@pytest.mark.parametrize("n", _EDGE_NS)
def test_k4_k5_k5_lse_bf16_tile_edges(dev, n, dh):
    """bf16 K4, K5 and K5-lse on the tensor cores where their 64-row tiles
    have edges: N one short of, on and one past a tile, and 816 (12 tiles
    and 48 keys), square and against a K/V length on the other side of a
    tile edge (Nq != Nk both ways), head sizes 8-128 (8 and 40 zero-padded
    in shared memory), bool and additive masks broadcast and per head,
    q/k/v strided views of the QKV GEMM output or contiguous.  Against the
    plain versions at the K1 bar; a bool mask's row 0 is fully masked:
    mean(V) over the Nk real keys in both kernels."""
    i = _EDGE_NS.index(n) + _EDGE_DHS.index(dh)
    for j, (nq, nk) in enumerate(((n, n), (n, _EDGE_NK[n]))):
        kind = _EDGE_MASKS[(i + j) % 4]
        packed = (i // 2 + j) % 2 == 0
        q, k, v = _heads(2, nq, nk, 2, dh, torch.bfloat16, dev, seed=90 + i, packed=packed)
        m = _fused_mask(kind, 2, 2, nq, nk, dev, seed=91 + i)
        for kernel in ("K4", "K5", "K5-lse"):
            got, tol = _fused_case(kernel, q, k, v, m)
            if kind.startswith("bool"):
                assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("kernel", ["K4", "K5", "K5-lse"])
@pytest.mark.parametrize("kind,nk", [("bool", 813), ("additive", 814),
                                     ("additive_per_head", 814)])
def test_k4_k5_unaligned_mask_rows(dev, kernel, kind, nk):
    """bf16 mask rows that are not 16-byte aligned (bool Nk = 813: byte
    copies; f32 Nk = 814: 4-byte copies), over 13 key tiles and a partial
    last one, as the multistate trunk's 816 keys cut short.  A bool mask's
    row 0 is fully masked: mean(V) over the Nk real keys."""
    nq, h, dh = 100, 2, 64
    q, k, v = _heads(2, nq, nk, h, dh, torch.bfloat16, dev, seed=92, packed=True)
    m = _fused_mask(kind, 2, h, nq, nk, dev, seed=93)
    got, tol = _fused_case(kernel, q, k, v, m)
    if kind == "bool":
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("nk", [65, 70, 129])
def test_k4_bf16_masked_and_minus_inf_rows_are_mean_v(dev, nk):
    """K4 has no max: a fully masked bool row and an additive -inf row both
    clamp every key to e^-80, so each is mean(V) over the Nk real keys, as
    `fused_attention_inference_plain` gives.  Keys past Nk in the ragged
    last tile weigh exactly 0 (never e^-80): with V shifted to a mean near
    3, counting the 15 zero-filled keys of the last 16-key block would give
    3 * Nk / (Nk + 15), far outside the bar."""
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(2, 70, nk, 2, 64, torch.bfloat16, dev, seed=94, packed=False)
    v = v + 3.0
    mean_v = v.float().mean(2)
    mb = _fused_mask("bool", 2, 2, 70, nk, dev, seed=95)  # row 0 fully masked
    ma = torch.zeros(2, 1, 70, nk, device=dev)
    ma[:, :, 3] = -torch.inf
    for m, row in ((mb, 0), (ma, 3)):
        got, tol = _fused_case("K4", q, k, v, m)
        with torch.inference_mode():
            want = fa.fused_attention_inference_plain(q, k, v, mask=m)
        assert (got[:, :, row].float() - mean_v).abs().max().item() <= tol
        assert (want[:, :, row].float() - mean_v).abs().max().item() <= tol


@pytest.mark.parametrize("kernel", ["K5", "K5-lse"])
def test_k5_bf16_minus_inf_row_gives_zeros(dev, kernel):
    """bf16 K5 and K5-lse on the tensor cores: an additive -inf row gives
    zeros and lse 0 (the TPU kernel's l == 0 guard), the other rows as the
    plain version."""
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(2, 70, 130, 2, 64, torch.bfloat16, dev, seed=96, packed=True)
    m = -100.0 * (torch.rand(2, 1, 70, 130, generator=torch.Generator().manual_seed(97))
                  < 0.3).float()
    m[1, 0, 3] = -torch.inf
    m = m.to(dev)
    got, _ = _fused_case(kernel, q, k, v, m)
    assert torch.equal(got[1, :, 3], torch.zeros_like(got[1, :, 3]))
    if kernel == "K5-lse":
        with torch.inference_mode():
            _, lse = fa.fused_attention_lse(q, k, v, mask=m)
        assert torch.equal(lse[1, :, 3], torch.zeros_like(lse[1, :, 3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [None, "additive", "bool"])
def test_k4_k5_k5_lse_deterministic(dev, dtype, mask):
    """No atomics: two calls of K4, of K5 and of K5-lse give the same bits."""
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(2, 197, 816, 3, 64, dtype, dev, seed=98, packed=True)
    m = _fused_mask(mask, 2, 3, 197, 816, dev, seed=99)
    with torch.inference_mode():
        for fn in (fa.fused_attention_inference, fa.fused_attention):
            a, b = (fn(q, k, v, mask=m) for _ in range(2))
            assert torch.equal(a, b)
        (a, la), (b, lb) = (fa.fused_attention_lse(q, k, v, mask=m) for _ in range(2))
        assert torch.equal(a, b) and torch.equal(la, lb)


# K5-lse: out as K5; lse 1e-5 of max(1, |lse|) (f32 sums in another order).
# K6: the kernel rounds p (into dV) and ds (into dQ, dK) to the compute dtype
# as the plain version does, but its f32 sums run in another order and can
# move a rounding by one bf16 step: bf16 2e-2, f32 1e-4, each of max(1,
# max |plain|).
_K6_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k6_check(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        tol = _K6_TOL[dtype] * max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol, name


def _ms_train_case(q, k, v, m, dtype, dev, seed):
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops import flash_attention as fl

    b, h, nq, dh = q.shape
    g = torch.randn(b, nq, h, dh, generator=torch.Generator().manual_seed(seed))
    g = g.to(dtype).to(dev).transpose(1, 2)  # strided, as autograd hands it
    n1, n2 = fa.fused_attention_lse.launches, fl.flash_attention_bwd.launches
    with torch.no_grad():
        o, lse = fa.fused_attention_lse(q, k, v, mask=m)
        wo, wl = fa.fused_attention_lse_plain(q, k, v, mask=m)
        got = fl.flash_attention_bwd(q, k, v, wo, g, wl, m)
        want = fl.flash_attention_bwd_plain(q, k, v, wo, g, wl, m)
    torch.cuda.synchronize()
    assert (fa.fused_attention_lse.launches, fl.flash_attention_bwd.launches) == (n1 + 1, n2 + 1)
    assert o.shape == q.shape and o.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    tol = _TOL[dtype] * max(1.0, wo.float().abs().max().item())
    assert (o.float() - wo.float()).abs().max().item() <= tol
    assert _lse_err(lse, wl) <= 1e-5
    _k6_check(got, want, dtype)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,h,dh,mask,packed", [
    (37, 37, 4, 16, None, False),
    (70, 70, 2, 32, "bool_per_head", True),
    (130, 130, 3, 64, "additive", True),
    (65, 200, 2, 128, "additive_per_head", False),  # K/V longer than Q
    (197, 816, 2, 64, "bool", True),  # cross-context at the bench kv length
    (5, 9, 3, 8, "bool_per_head", False),
    (100, 30, 2, 40, "additive", False),  # Q longer than K/V
    (96, 96, 2, 128, "bool", True),
])
def test_k5_lse_and_k6_match_plain(dev, dtype, nq, nk, h, dh, mask, packed):
    """K5-lse (out, lse) and K6 (dq, dk, dv from the plain forward's
    residuals and a strided cotangent) against their plain versions at odd
    shapes: N not a multiple of 64, head sizes 8-128, Nq != Nk, every mask
    kind per head and broadcast, q/k/v strided views of the QKV GEMM output
    or contiguous.  A bool mask's row 0 is fully masked."""
    q, k, v = _heads(2, nq, nk, h, dh, dtype, dev, seed=40, packed=packed)
    _ms_train_case(q, k, v, _fused_mask(mask, 2, h, nq, nk, dev, seed=41), dtype, dev, 42)


def test_k5_lse_and_k6_large_logits_and_minus_inf_rows(dev):
    """q and k x 12 (|s| in the hundreds): exact and finite; an additive
    -inf row: out zeros, lse 0, and no gradient through it."""
    q, k, v = _heads(2, 70, 90, 2, 64, torch.float32, dev, seed=43, packed=True)
    m = torch.zeros(2, 1, 70, 90, device=dev)
    m[1, 0, 3] = -torch.inf
    from msvit_tpu_torch.ops import fused_attention as fa

    dq, dk, dv = _ms_train_case(q * 12, k * 12, v, m, torch.float32, dev, 44)
    with torch.no_grad():
        o, lse = fa.fused_attention_lse(q * 12, k * 12, v, mask=m)
    assert torch.equal(o[1, :, 3], torch.zeros_like(o[1, :, 3]))
    assert torch.equal(lse[1, :, 3], torch.zeros_like(lse[1, :, 3]))
    assert torch.equal(dq[1, :, 3], torch.zeros_like(dq[1, :, 3]))


@pytest.mark.parametrize("nq,nk,h,dh,mask,packed", [
    (65, 129, 2, 40, "bool_per_head", True),  # Nq != Nk, one past a tile
    (129, 63, 3, 72, "additive", False),
    (64, 64, 2, 16, "additive_per_head", True),
    (63, 65, 2, 128, "bool", False),
    (100, 1100, 2, 64, "bool", True),  # bool rows not 16-byte aligned
    (100, 1100, 2, 64, "additive_per_head", False),
    (70, 37, 2, 64, "bool_per_head", True),  # nor 4-byte aligned: byte copies
    (70, 37, 2, 32, "additive", False),  # f32 rows not 16-byte aligned
])
def test_k6_bf16_tile_edges(dev, nq, nk, h, dh, mask, packed):
    """bf16 K6 on the tensor cores where its 64-row tiles and its staged
    mask tile have edges: Nq != Nk both ways, head sizes 16-128 (40 and 72
    zero-padded), mask rows copied 16, 4 or 1 bytes at a time (Nk = 1100,
    37), every mask kind per head and broadcast.  Against the plain version
    on the same residuals and strided cotangent, K6's bar.  A bool mask's
    row 0 is fully masked (p = 1 on every key)."""
    q, k, v = _heads(2, nq, nk, h, dh, torch.bfloat16, dev, seed=75, packed=packed)
    m = _fused_mask(mask, 2, h, nq, nk, dev, seed=76)
    _ms_train_case(q, k, v, m, torch.bfloat16, dev, 77)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_fully_masked_row_gives_p_one(dev, dtype):
    """A bool row with every key masked has lse = mask_value + log Nk, which
    rounds to mask_value, so its p = exp(s - lse) is 1 on every key (the
    TPU's and the plain version's): with the cotangent zero on every other
    row, dv of each key is that row's g, exactly, on the kernel and the
    plain version alike."""
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import fused_attention as fa

    b, h, nq, nk, dh = 2, 2, 70, 90, 64
    q, k, v = _heads(b, nq, nk, h, dh, dtype, dev, seed=78, packed=True)
    m = _fused_mask("bool", b, h, nq, nk, dev, seed=79)  # row 0 fully masked
    g = torch.zeros(b, h, nq, dh, dtype=dtype, device=dev)
    g[:, :, 0] = torch.randn(b, h, dh, generator=torch.Generator().manual_seed(80)).to(dtype).to(dev)
    with torch.no_grad():
        out, lse = fa.fused_attention_lse_plain(q, k, v, mask=m)
        got = fl.flash_attention_bwd(q, k, v, out, g, lse, m)
        want = fl.flash_attention_bwd_plain(q, k, v, out, g, lse, m)
    torch.cuda.synchronize()
    row = g[:, :, :1].expand(b, h, nk, dh)
    assert torch.equal(got[2], row) and torch.equal(want[2], row)
    _k6_check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_minus_inf_row_gives_zeros(dev, dtype):
    """An additive -inf row: the forward writes zeros and lse 0, so p = 0 on
    the row (not NaN): its dq is zeros, every gradient finite, and the rest
    within K6's bar of the plain version."""
    q, k, v = _heads(2, 70, 130, 2, 64, dtype, dev, seed=81, packed=True)
    m = -100.0 * (torch.rand(2, 1, 70, 130, generator=torch.Generator().manual_seed(82))
                  < 0.3).float()
    m[1, 0, 3] = -torch.inf
    dq, dk, dv = _ms_train_case(q, k, v, m.to(dev), dtype, dev, 83)
    assert torch.equal(dq[1, :, 3], torch.zeros_like(dq[1, :, 3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [None, "additive", "bool"])
def test_k6_deterministic(dev, dtype, mask):
    """No atomics: two calls of K6 give the same bits."""
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(2, 197, 300, 3, 64, dtype, dev, seed=84, packed=True)
    m = _fused_mask(mask, 2, 3, 197, 300, dev, seed=85)
    g = torch.randn(2, 197, 3, 64, generator=torch.Generator().manual_seed(86))
    g = g.to(dtype).to(dev).transpose(1, 2)
    with torch.no_grad():
        out, lse = fa.fused_attention_lse(q, k, v, mask=m)
        a, b = (fl.flash_attention_bwd(q, k, v, out, g, lse, m) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_grads_match_plain_function(dev, dtype):
    """Autograd through `fused_attention` on the card (FusedAttentionFunction:
    K5-lse, K6) against the same Function on CPU copies (the plain
    versions), q/k/v views of one QKV GEMM output with the multistate soft
    mask: value and the QKV output's gradient within K6's bar."""
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, n, h, dh = 2, 130, 3, 64
    gen = torch.Generator().manual_seed(45)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(dtype)
    m = -100.0 * (torch.rand(b, 1, n, n, generator=gen) < 0.3).float()
    w = torch.randn(b, h, n, dh, generator=gen)
    grads = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_()
        q, k, v = unpack_qkv(xd, h)
        out = fa.fused_attention(q, k, v, mask=m.to(d))
        (out.float() * w.to(d)).sum().backward()
        grads.append(xd.grad.cpu())
    torch.cuda.synchronize()
    tol = _K6_TOL[dtype] * max(1.0, grads[1].float().abs().max().item())
    assert (grads[0].float() - grads[1].float()).abs().max().item() <= tol


# K5, K5-lse and K6 on the wgmma route (bf16, head size 64).


@pytest.mark.parametrize("b,nq,nk,h,mask,packed", [
    (2, 816, 816, 12, "additive", True),  # the multistate trunk's soft mask, broadcast
    (8, 816, 816, 12, "additive", True),  # its whole shape: 672 items on 132 blocks
    (2, 197, 816, 3, "bool", True),  # cross-context; row 0 fully masked: mean(V)
    (2, 300, 130, 2, "bool_per_head", False),  # Q longer than K/V
    (2, 5, 9, 2, "additive_per_head", False),
])
def test_k5_k5_lse_wgmma_shapes(dev, b, nq, nk, h, mask, packed):
    """K5 and K5-lse take the kernel K7 runs at bf16 head size 64 (one
    wgmma launch each; `_fused_case`): out within the K1 bar, lse within
    1e-5 of max(1, |lse|), K5-lse's out K5's bits."""
    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=60, packed=packed)
    m = _fused_mask(mask, b, h, nq, nk, dev, seed=61)
    for kernel in ("K5", "K5-lse"):
        got, tol = _fused_case(kernel, q, k, v, m)
        if mask is not None and mask.startswith("bool"):
            assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_k5_k5_lse_wgmma_key_only_masks(dev, kind):
    """The depth-3 subsample trunk's key-only masks at [2, 2, 1361, 64]:
    K5 and K5-lse on wgmma, bit-equal to the mask expanded in memory."""
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(2, 1361, 1361, 2, 64, torch.bfloat16, dev, seed=62, packed=True)
    m = _key_mask(kind, 2, 1361, dev, seed=63)
    full = m.expand(-1, -1, 1361, -1).contiguous()
    for kernel in ("K5", "K5-lse"):
        got, _ = _fused_case(kernel, q, k, v, m)
        with torch.inference_mode():
            assert torch.equal(got, fa.fused_attention(q, k, v, mask=full))
            assert torch.equal(fa.fused_attention_lse(q, k, v, mask=m)[1],
                               fa.fused_attention_lse(q, k, v, mask=full)[1])


# K4 on the wgmma route (bf16, head size 64): the kernel K1 runs, with l
# summed from the unrounded p.


def _k4_wgmma_mask(kind, b, h, nq, nk, dev, seed):
    """K4's masks on the wgmma route: kind "bool", "additive", "minus_inf"
    (an additive mask whose row 0 is all -inf) or "key_only" (an additive
    [., ., 1, Nk] row read at pitch 0), `b` and `h` its image and head
    extents (1 where broadcast).  Row 0 of the bool mask is fully masked."""
    g = torch.Generator().manual_seed(seed)
    if kind == "key_only":
        return _key_mask("additive", b, nk, dev, seed).expand(b, h, 1, nk)
    if kind == "bool":
        m = torch.rand(b, h, nq, nk, generator=g) < 0.7
        m[:, :, 0] = False
        return m.to(dev)
    m = -100.0 * (torch.rand(b, h, nq, nk, generator=g) < 0.3).float()
    if kind == "minus_inf":
        m[:, :, 0] = -torch.inf
    return m.to(dev)


@pytest.mark.parametrize("kind", ["bool", "additive", "minus_inf", "key_only"])
@pytest.mark.parametrize("over", ["images", "heads"])
@pytest.mark.parametrize("nq,nk", [(197, 130), (70, 816)])
def test_k4_wgmma_masks(dev, kind, over, nq, nk):
    """K4 on the wgmma route (one launch, `_fused_case`) against its plain
    version with every mask kind, broadcast over the images ([1, H, ., Nk])
    or over the heads ([B, 1, ., Nk]), Nq and Nk off 64 and 128 and
    unequal: at the K1 bar; a fully masked bool row and an all -inf row are
    mean(V) over the Nk real keys (keys past Nk weigh 0, not e^-80)."""
    b, h = 2, 3
    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=64 + nq, packed=True)
    m = _k4_wgmma_mask(kind, 1 if over == "images" else b, h if over == "images" else 1,
                       nq, nk, dev, seed=65 + nk)
    got, tol = _fused_case("K4", q, k, v, m)
    if kind in ("bool", "minus_inf"):
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("b,nq,nk,h,mask,packed", [
    (8, 816, 816, 12, "additive", True),  # the int8 serving trunk's shape
    (2, 300, 130, 2, "bool_per_head", False),  # Q longer than K/V
    (2, 5, 9, 2, "additive_per_head", False),
])
def test_k4_wgmma_shapes(dev, b, nq, nk, h, mask, packed):
    """K4 on the wgmma route at the serving trunk's whole shape (672 items
    on the persistent grid) and at small and ragged ones, against its plain
    version; two calls give the same bits."""
    from msvit_tpu_torch.ops import fused_attention as fa

    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=66, packed=packed)
    m = _fused_mask(mask, b, h, nq, nk, dev, seed=67)
    got, tol = _fused_case("K4", q, k, v, m)
    if mask.startswith("bool"):
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol
    with torch.inference_mode():
        assert torch.equal(got, fa.fused_attention_inference(q, k, v, mask=m))


def test_k4_wgmma_refuses_a_view_tma_cannot_map(dev):
    """A q view whose row pitch is 136 bytes raises on K4's wgmma route,
    naming the wrapper; nothing launches."""
    from msvit_tpu_torch.ops import fused_attention as fa

    base = torch.zeros(2, 70, 68, dtype=torch.bfloat16, device=dev)
    q = base[..., :64].unsqueeze(1)
    k = v = torch.zeros(2, 1, 70, 64, dtype=torch.bfloat16, device=dev)
    before = route_counts()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="fused_attention_inference: TMA"):
            fa.fused_attention_inference(q, k, v)
    _took(before, {})


@pytest.mark.parametrize("dtype,dh,route", [(torch.bfloat16, 32, "mma.sync"),
                                            (torch.float32, 64, "cuda_cores")])
def test_fused_misaligned_contiguous_views_are_copied(dev, dtype, dh, route):
    """Off the wgmma route, a q, k or v that is contiguous but starts off 16
    bytes is copied into fresh storage (`contiguous()` would hand the same
    view back, and the kernels' 16-byte loads fault on it): K4 and K5 then
    match their plain versions, one launch each on their route."""
    b, h, n = 2, 2, 70
    flat = torch.randn(1 + 3 * b * h * n * dh, generator=torch.Generator().manual_seed(68))
    q, k, v = flat.to(dtype).to(dev)[1:].view(3, b, h, n, dh).unbind(0)
    assert q.is_contiguous() and q.data_ptr() % 16
    for kernel in ("K4", "K5"):
        before = route_counts()
        _fused_case(kernel, q, k, v, None)
        _took(before, {kernel: route})


def _k6_wgmma_case(q, k, v, m, seed, route="wgmma", g=None):
    """K6 from the plain forward's residuals and a cotangent (default: the
    strided [B, H, Nq, 64] view autograd hands over) against its plain
    version at K6's bar: one launch on `route`, and a second call gives the
    same bits.  Returns dq, dk, dv."""
    from msvit_tpu_torch.ops import flash_attention as fl

    b, h, nq, dh = q.shape
    if g is None:
        g = torch.randn(b, nq, h, dh, generator=torch.Generator().manual_seed(seed))
        g = g.to(q.dtype).to(q.device).transpose(1, 2)
    with torch.no_grad():
        wo, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
        before = route_counts()
        got = fl.flash_attention_bwd(q, k, v, wo, g, wl, m)
        torch.cuda.synchronize()
        _took(before, {"K6": route})
        again = fl.flash_attention_bwd(q, k, v, wo, g, wl, m)
        want = fl.flash_attention_bwd_plain(q, k, v, wo, g, wl, m)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _k6_check(got, want, q.dtype)
    return got


@pytest.mark.parametrize("b,nq,nk,h,mask,packed", [
    (2, 816, 816, 12, "additive", True),  # the multistate trunk's soft mask, broadcast
    (8, 816, 816, 12, "additive", True),  # its whole shape: 672 items on 132 blocks
    (2, 197, 300, 3, "bool", True),  # row 0 fully masked: p = 1 on every key
    (2, 197, 816, 3, "additive", True),  # cross-context Nq 197, Nk 816
    (2, 816, 813, 2, "bool", True),  # bool rows of 813 bytes: not pair-aligned
    (2, 816, 814, 2, "additive_per_head", False),  # f32 rows off 16 bytes
    (2, 300, 130, 2, "bool_per_head", False),  # Q longer than K/V
    (2, 5, 9, 2, None, False),  # one ragged tile each way
    (2, 129, 63, 3, "additive", True),
])
def test_k6_wgmma_shapes(dev, b, nq, nk, h, mask, packed):
    """K6 on wgmma at bf16 head size 64: strided views of packed QKV outputs
    or contiguous tensors, every mask form, Nq != Nk both ways, ragged
    tiles; against its plain version at K6's bar, two calls the same
    bits."""
    q, k, v = _heads(b, nq, nk, h, 64, torch.bfloat16, dev, seed=64, packed=packed)
    _k6_wgmma_case(q, k, v, _fused_mask(mask, b, h, nq, nk, dev, seed=65), seed=66)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("nq", [1025, 1361])
def test_k6_wgmma_key_only_masks(dev, kind, nq):
    """The depth-3 subsample trunk's key-only masks ([B, 1, 1, 1361], read
    at row pitch 0, never expanded): K6 on wgmma, bit-equal to K6 given the
    mask expanded in memory."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(2, nq, 1361, 2, 64, torch.bfloat16, dev, seed=67, packed=True)
    m = _key_mask(kind, 2, 1361, dev, seed=68)
    got = _k6_wgmma_case(q, k, v, m, seed=69)
    g = torch.randn(2, nq, 2, 64, generator=torch.Generator().manual_seed(69))
    g = g.to(torch.bfloat16).to(dev).transpose(1, 2)
    with torch.no_grad():
        wo, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
        full = fl.flash_attention_bwd(q, k, v, wo, g, wl, m.expand(-1, -1, nq, -1).contiguous())
    assert all(torch.equal(a, c) for a, c in zip(got, full))


def test_k6_wgmma_expanded_cotangent_is_copied(dev):
    """A cotangent with strides (0, 0, 0, 1), which no TMA map takes: the
    wrapper copies it and the wgmma kernels run (one launch); the result is
    the plain version's on the expanded tensor."""
    q, k, v = _heads(2, 197, 197, 3, 64, torch.bfloat16, dev, seed=70, packed=True)
    w = torch.randn(64, generator=torch.Generator().manual_seed(71)).to(torch.bfloat16)
    g = w.to(dev).expand(2, 3, 197, 64)
    assert g.stride() == (0, 0, 0, 1)
    _k6_wgmma_case(q, k, v, _fused_mask("additive", 2, 3, 197, 197, dev, seed=72),
                   seed=0, g=g)


def test_k6_wgmma_refuses_a_view_tma_cannot_map(dev):
    """A q view whose row pitch is 136 bytes raises on K6's wgmma route,
    naming the wrapper; nothing launches, nothing goes to another route."""
    from msvit_tpu_torch.ops import flash_attention as fl

    base = torch.zeros(2, 70, 68, dtype=torch.bfloat16, device=dev)
    q = base[..., :64].unsqueeze(1)  # [2, 1, 70, 64], rows 68 elements apart
    k = v = o = torch.zeros(2, 1, 70, 64, dtype=torch.bfloat16, device=dev)
    lse = torch.zeros(2, 1, 70, device=dev)
    before = route_counts()
    with pytest.raises(ValueError, match="flash_attention_bwd: TMA"):
        fl.flash_attention_bwd(q, k, v, o, o, lse)
    _took(before, {})


@pytest.mark.parametrize("dh,dtype,route", [(128, torch.bfloat16, "mma.sync"),
                                            (32, torch.bfloat16, "mma.sync"),
                                            (64, torch.float32, "cuda_cores")])
def test_k6_other_routes(dev, dh, dtype, route):
    """bf16 head sizes other than 64 keep K6's mma.sync kernels, f32 the
    CUDA cores: the route counters say so."""
    q, k, v = _heads(2, 130, 150, 2, dh, dtype, dev, seed=73, packed=True)
    _k6_wgmma_case(q, k, v, _fused_mask("bool", 2, 2, 130, 150, dev, seed=74), seed=75,
                   route=route)


@pytest.mark.parametrize("loss", ["sum", "w64"])
def test_fused_function_grads_of_broadcast_cotangents(dev, loss):
    """Autograd through `fused_attention` on the card (K5-lse forward, K6
    backward, both on wgmma) for out.sum() and (out * w).sum() with w of
    shape [64], whose cotangents arrive expanded, against the same Function
    on CPU copies (the plain versions): the QKV output's gradient within
    K6's bar."""
    from msvit_tpu_torch.ops import fused_attention as fa

    b, n, h, dh = 2, 197, 3, 64
    gen = torch.Generator().manual_seed(76)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(torch.bfloat16)
    m = -100.0 * (torch.rand(b, 1, n, n, generator=gen) < 0.3).float()
    w = torch.randn(dh, generator=gen).to(torch.bfloat16)
    grads = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_()
        q, k, v = unpack_qkv(xd, h)
        before = route_counts() if d.type == "cuda" else None
        out = fa.fused_attention(q, k, v, mask=m.to(d))
        (out.sum() if loss == "sum" else (out * w.to(d)).sum()).backward()
        if before is not None:
            torch.cuda.synchronize()
            _took(before, {"K5-lse": "wgmma", "K6": "wgmma"})
        grads.append(xd.grad.cpu())
    tol = _K6_TOL[torch.bfloat16] * max(1.0, grads[1].float().abs().max().item())
    assert (grads[0].float() - grads[1].float()).abs().max().item() <= tol


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


# ------------------------------------------------------------ K7, K7-lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,h,dh,mask,packed", [
    (37, 37, 4, 16, None, False),
    (70, 70, 2, 32, "bool_per_head", True),
    (130, 130, 3, 64, "additive", True),
    (65, 200, 2, 128, "additive_per_head", False),  # K/V longer than Q
    (5, 9, 3, 8, "bool_per_head", False),
    (100, 30, 2, 40, "additive", False),  # Q longer than K/V
    (600, 1100, 2, 64, "additive", True),  # many tiles each way
    (96, 96, 2, 128, "bool", True),
])
def test_k7_and_k7_lse_match_plain(dev, dtype, nq, nk, h, dh, mask, packed):
    """K7 and K7-lse against their plain versions at odd shapes (N not a
    multiple of 64, head sizes 8-128, Nq != Nk), every mask kind per head
    and broadcast (the mask tile staged in shared memory), q/k/v strided
    views or contiguous; tolerances as K5 (bf16: p rounded against the
    running max where the plain version rounds it against the row's max),
    lse 1e-5 of max(1, |lse|).  A bool mask's row 0 is fully masked:
    mean(V)."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(2, nq, nk, h, dh, dtype, dev, seed=50, packed=packed)
    m = _fused_mask(mask, 2, h, nq, nk, dev, seed=51)
    n7, nl = fl.flash_attention.launches, fl.flash_attention_lse.launches
    with torch.inference_mode():
        got = fl.flash_attention(q, k, v, mask=m)
        o, lse = fl.flash_attention_lse(q, k, v, mask=m)
        want, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert (fl.flash_attention.launches, fl.flash_attention_lse.launches) == (n7 + 1, nl + 1)
    assert got.shape == (2, h, nq, dh) and got.dtype == dtype
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    assert torch.equal(got, o)
    tol = _TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _lse_err(lse, wl) <= 1e-5
    if mask is not None and mask.startswith("bool"):
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


def test_k7_large_logits_and_minus_inf_rows(dev):
    """K7 is exact at any logit scale (q and k x 12); an additive -inf row
    gives zeros and lse 0, as the TPU kernel's l == 0 guard."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(2, 70, 90, 2, 64, torch.float32, dev, seed=52, packed=True)
    m = torch.zeros(2, 1, 70, 90, device=dev)
    m[1, 0, 3] = -torch.inf
    with torch.inference_mode():
        got, lse = fl.flash_attention_lse(q * 12, k * 12, v, mask=m)
        want, wl = fl.flash_attention_lse_plain(q * 12, k * 12, v, mask=m)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, :, 3], torch.zeros_like(got[1, :, 3]))
    assert torch.equal(lse[1, :, 3], torch.zeros_like(lse[1, :, 3]))
    assert (got - want).abs().max().item() <= 1e-4
    assert _lse_err(lse, wl) <= 1e-5


def test_k7_bf16_minus_inf_row_gives_zeros(dev):
    """bf16 on the tensor cores: an additive -inf row gives zeros and lse 0
    (the TPU kernel's l == 0 guard), the other rows as the plain version,
    out equal with and without the lse."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(2, 70, 130, 2, 64, torch.bfloat16, dev, seed=66, packed=True)
    m = -100.0 * (torch.rand(2, 1, 70, 130, generator=torch.Generator().manual_seed(67))
                  < 0.3).float()
    m[1, 0, 3] = -torch.inf
    m = m.to(dev)
    with torch.inference_mode():
        got, lse = fl.flash_attention_lse(q, k, v, mask=m)
        out = fl.flash_attention(q, k, v, mask=m)
        want, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    assert torch.equal(got, out)
    assert torch.equal(got[1, :, 3], torch.zeros_like(got[1, :, 3]))
    assert torch.equal(lse[1, :, 3], torch.zeros_like(lse[1, :, 3]))
    tol = _TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _lse_err(lse, wl) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,nk", [("bool", 1100), ("bool", 1101), ("bool", 9),
                                     ("additive", 1101), ("additive_per_head", 1101)])
def test_k7_unaligned_mask_rows(dev, dtype, kind, nk):
    """Mask rows that are not 16-byte aligned (bool Nk % 16 != 0, f32
    Nk % 4 != 0), across several key tiles and a partial last one: the
    kernel copies them at the granularity the alignment allows.  A bool
    mask's row 0 is fully masked: mean(V) over the Nk real keys."""
    from msvit_tpu_torch.ops import flash_attention as fl

    nq, h, dh = 100, 2, 64
    q, k, v = _heads(2, nq, nk, h, dh, dtype, dev, seed=68, packed=True)
    m = _fused_mask(kind, 2, h, nq, nk, dev, seed=69)
    with torch.inference_mode():
        got, lse = fl.flash_attention_lse(q, k, v, mask=m)
        out = fl.flash_attention(q, k, v, mask=m)
        want, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    tol = _TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _lse_err(lse, wl) <= 1e-5
    if kind == "bool":
        assert (got[:, :, 0].float() - v.float().mean(2)).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [None, "additive", "bool"])
def test_k7_deterministic(dev, dtype, mask):
    """No atomics: two calls of K7 and of K7-lse give the same bits, and
    K7's out is K7-lse's."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(2, 197, 300, 3, 64, dtype, dev, seed=70, packed=True)
    m = _fused_mask(mask, 2, 3, 197, 300, dev, seed=71)
    with torch.inference_mode():
        o1, o2 = (fl.flash_attention(q, k, v, mask=m) for _ in range(2))
        (a1, l1), (a2, l2) = (fl.flash_attention_lse(q, k, v, mask=m) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(a1, a2) and torch.equal(l1, l2)
    assert torch.equal(o1, a1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_grads_match_plain_function(dev, dtype):
    """Autograd through `flash_attention` on the card (FlashAttentionFunction:
    K7-lse, K6; one launch each, no K7) against the same Function on CPU
    copies, q/k/v views of one QKV output with a soft mask: the QKV output's
    gradient within K6's bar."""
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, n, h, dh = 2, 130, 3, 64
    gen = torch.Generator().manual_seed(53)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(dtype)
    m = -100.0 * (torch.rand(b, 1, n, n, generator=gen) < 0.3).float()
    w = torch.randn(b, h, n, dh, generator=gen)
    n7, nl, nb = (fl.flash_attention.launches, fl.flash_attention_lse.launches,
                  fl.flash_attention_bwd.launches)
    grads = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_()
        q, k, v = unpack_qkv(xd, h)
        (fl.flash_attention(q, k, v, mask=m.to(d)).float() * w.to(d)).sum().backward()
        grads.append(xd.grad.cpu())
    torch.cuda.synchronize()
    assert (fl.flash_attention.launches, fl.flash_attention_lse.launches,
            fl.flash_attention_bwd.launches) == (n7, nl + 1, nb + 1)
    tol = _K6_TOL[dtype] * max(1.0, grads[1].float().abs().max().item())
    assert (grads[0].float() - grads[1].float()).abs().max().item() <= tol


def test_k7_refuses_bad_inputs(dev):
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(1, 37, 37, 2, 16, torch.float32, dev, seed=54, packed=False)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head size"):
            fl.flash_attention(q[..., :12], k[..., :12], v[..., :12])
        with pytest.raises(TypeError):
            fl.flash_attention(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="mask"):
            fl.flash_attention(q, k, v, mask=torch.ones(1, 1, 37, 36, dtype=torch.bool,
                                                        device=dev))
        with pytest.raises(ValueError, match="no kernel"):
            fl.flash_attention(q, k.cpu(), v)


# ------------------------------------------------------- key-only masks


def _key_mask(kind, b, nk, dev, seed):
    """A key-only mask [b, 1, 1, Nk], the subsample trunk's: key 0 (CLS)
    always attended, ~40% of the others masked; bool (True = attend), or
    additive: 0 / -1e30 for valid / masked plus -log(4) x depth (0-3) on
    every key, the weighted-token bias."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand(b, 1, 1, nk, generator=g) < 0.6
    valid[..., 0] = True
    if kind == "bool":
        return valid.to(dev)
    depth = torch.randint(0, 4, (nk,), generator=g).float()
    return (torch.where(valid, 0.0, -1e30) - 1.3862943611198906 * depth).to(dev)


_KEY_ONLY_SHAPES = [
    (70, 70, 2, 64),  # Nq = Nk, one key tile and a ragged second
    (100, 137, 3, 32),  # Nq != Nk, Nk not a multiple of 64 (nor of 4: unaligned rows)
    (130, 65, 2, 128),  # Q longer than K/V
    (1025, 1361, 2, 64),  # the depth-3 subsample trunk's freeze iteration
    (1361, 1361, 1, 64),  # ... and its open iteration
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("images", ["B", "1"])
@pytest.mark.parametrize("nq,nk,h,dh", _KEY_ONLY_SHAPES)
def test_key_only_masks_k4_k5_k7(dev, dtype, kind, images, nq, nk, h, dh):
    """K4, K5, K5-lse, K7 and K7-lse with a key-only mask [B|1, 1, 1, Nk]
    (read through a row stride of 0, never expanded) against their plain
    versions at the existing bars, and bit-equal to the same kernel given
    the mask expanded to [B|1, 1, Nq, Nk] in memory."""
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import fused_attention as fa

    b = 2
    q, k, v = _heads(b, nq, nk, h, dh, dtype, dev, seed=90, packed=True)
    m = _key_mask(kind, b if images == "B" else 1, nk, dev, seed=91)
    full = m.expand(-1, -1, nq, -1).contiguous()
    fns = [(fa.fused_attention_inference, fa.fused_attention_inference_plain),
           (fa.fused_attention, fa.fused_attention_plain),
           (fl.flash_attention, fl.flash_attention_plain)]
    with torch.inference_mode():
        for fn, plain in fns:
            before = fn.launches
            got, again = fn(q, k, v, mask=m), fn(q, k, v, mask=full)
            want = plain(q, k, v, mask=m)
            torch.cuda.synchronize()
            assert fn.launches == before + 2, fn.__name__
            assert torch.isfinite(got).all(), fn.__name__
            assert torch.equal(got, again), fn.__name__
            tol = _TOL[dtype] * max(1.0, want.float().abs().max().item())
            assert (got.float() - want.float()).abs().max().item() <= tol, fn.__name__
        for fn in (fa.fused_attention_lse, fl.flash_attention_lse):
            (o, lse), (o2, lse2) = fn(q, k, v, mask=m), fn(q, k, v, mask=full)
            wo, wl = fa.fused_attention_lse_plain(q, k, v, mask=m)
            torch.cuda.synchronize()
            assert torch.equal(o, o2) and torch.equal(lse, lse2), fn.__name__
            tol = _TOL[dtype] * max(1.0, wo.float().abs().max().item())
            assert (o.float() - wo.float()).abs().max().item() <= tol, fn.__name__
            assert _lse_err(lse, wl) <= 1e-5, fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("images", ["B", "1"])
@pytest.mark.parametrize("nq,nk,h,dh", _KEY_ONLY_SHAPES[:4])
def test_key_only_masks_k6(dev, dtype, kind, images, nq, nk, h, dh):
    """K6 (dq, dk, dv) with a key-only mask against its plain version at
    K6's bars (the plain forward's residuals, a strided cotangent), and
    bit-equal to K6 given the expanded mask."""
    from msvit_tpu_torch.ops import flash_attention as fl

    b = 2
    q, k, v = _heads(b, nq, nk, h, dh, dtype, dev, seed=92, packed=True)
    m = _key_mask(kind, b if images == "B" else 1, nk, dev, seed=93)
    g = torch.randn(b, nq, h, dh, generator=torch.Generator().manual_seed(94))
    g = g.to(dtype).to(dev).transpose(1, 2)
    with torch.no_grad():
        wo, wl = fl.flash_attention_lse_plain(q, k, v, mask=m)
        before = fl.flash_attention_bwd.launches
        got = fl.flash_attention_bwd(q, k, v, wo, g, wl, m)
        again = fl.flash_attention_bwd(q, k, v, wo, g, wl,
                                       m.expand(-1, -1, nq, -1).contiguous())
        want = fl.flash_attention_bwd_plain(q, k, v, wo, g, wl, m)
    torch.cuda.synchronize()
    assert fl.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _k6_check(got, want, dtype)


def test_key_only_mask_is_not_expanded(dev):
    """The wrappers hand the kernels the key-only mask itself (row stride
    0): a [8, 1, 1, 1361] f32 mask costs no [8, 1, 1361, 1361] copy, so a
    call allocates no more than its output."""
    from msvit_tpu_torch.ops import flash_attention as fl

    q, k, v = _heads(8, 1361, 1361, 12, 64, torch.bfloat16, dev, seed=95, packed=True)
    m = _key_mask("additive", 8, 1361, dev, seed=96)
    with torch.inference_mode():
        fl.flash_attention(q, k, v, mask=m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fl.flash_attention(q, k, v, mask=m)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 2 * q.numel() * 2


# ------------------------------------------------------------------- K9


_K9_MASKS = [None, "bool", "additive", "additive_per_head", "bool_batch",
             "additive_batch"]


def _k9_mask(kind, b, h, n, dev, seed):
    """`_fused_mask`'s kinds, and "*_batch": one [1, 1, N, N] panel
    broadcast over the batch and the heads."""
    if kind is not None and kind.endswith("_batch"):
        return _fused_mask(kind[:-len("_batch")], 1, h, n, n, dev, seed)
    return _fused_mask(kind, b, h, n, n, dev, seed)


def _k9_case(q, sec, h, m):
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_int8_masked, packed_attention_int8_masked_plain)

    before = packed_attention_int8_masked.launches
    with torch.inference_mode():
        got = packed_attention_int8_masked(q, sec, h, mask=m)
        want = packed_attention_int8_masked_plain(q, sec, h, mask=m)
        inv = 127.0 / want.float().abs().amax()
        got_q = packed_attention_int8_masked(q, sec, h, mask=m, out_inv_scale=inv,
                                             int8_out=True)
        want_q = packed_attention_int8_masked_plain(q, sec, h, mask=m, out_inv_scale=inv,
                                                    int8_out=True)
    torch.cuda.synchronize()
    assert packed_attention_int8_masked.launches == before + 2
    return got, want, got_q, want_q


def _mean_v(q, sec):
    """s_v times the mean over the keys of v, [B, D]: the output of a fully
    masked row (pq = 127 on every key)."""
    return q[..., 2 * q.shape[-1] // 3:].float().mean(1) * sec[2]


@pytest.mark.parametrize("mask", _K9_MASKS)
@pytest.mark.parametrize("n,h,dh", [(40, 4, 64), (197, 12, 64), (37, 2, 16), (70, 2, 128)]
                         + _INT8_SHAPES[3:])
def test_k9_matches_plain(dev, mask, n, h, dh):
    """K9 on the int8 tensor cores against its plain version, bf16 and int8
    out (`_int8_bars`), with every mask kind: none, bool (row 0 fully
    masked: mean(V) over the N real keys), the bf16 additive soft mask,
    per head, one panel broadcast over the batch; at the tile edges too
    (odd N: mask rows that are not 16-byte aligned)."""
    q, sec = _int8(2, n, h * dh, dev, seed=55)
    m = _k9_mask(mask, 2, h, n, dev, seed=56)
    got, want, got_q, want_q = _k9_case(q, sec, h, m)
    _int8_bars(got, want, got_q, want_q)
    if mask is not None and mask.startswith("bool"):
        mean = _mean_v(q, sec)
        assert (got[:, 0].float() - mean).abs().max().item() <= (
            2e-2 * want.float().abs().max().item())


@pytest.mark.parametrize("mask,n", [("bool", 813), ("additive", 813), ("additive", 814),
                                    ("bool_batch", 815), ("additive_per_head", 817)])
def test_k9_unaligned_mask_rows(dev, mask, n):
    """Mask rows that are not 16-byte aligned over 13 key tiles and a partial
    last one: bool N 813/815 (byte copies), bf16 N 813/817 (2-byte copies)
    and 814 (4-byte copies)."""
    q, sec = _int8(2, n, 2 * 64, dev, seed=57)
    m = _k9_mask(mask, 2, 2, n, dev, seed=58)
    _int8_bars(*_k9_case(q, sec, 2, m))


def test_k9_long_rows_at_the_bf16_bar(dev):
    """K9 at the 448-px token count (3168, 50 key tiles) with the soft mask:
    bf16 out within 2% of the range, int8 out |delta| <= 1."""
    q, sec = _int8(1, 3168, 2 * 64, dev, seed=59)
    m = _k9_mask("additive", 1, 2, 3168, dev, seed=60)
    got, want, got_q, want_q = _k9_case(q, sec, 2, m)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    assert (got_q.int() - want_q.int()).abs().max().item() <= 1


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_k3_k9_deterministic(dev, mask):
    """Two calls give bit-equal outputs (no atomics, a fixed order of
    sums), bf16 and int8 out."""
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked

    q, sec = _int8(2, 197, 12 * 64, dev, seed=61)
    m = _k9_mask(mask, 2, 12, 197, dev, seed=62)
    with torch.inference_mode():
        for out8 in (False, True):
            inv = torch.tensor(3.0, device=dev) if out8 else None
            a = packed_attention_int8_masked(q, sec, 12, mask=m, out_inv_scale=inv,
                                             int8_out=out8)
            b = packed_attention_int8_masked(q, sec, 12, mask=m, out_inv_scale=inv,
                                             int8_out=out8)
            assert torch.equal(a, b)
            if mask is None:
                a = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=out8)
                b = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=out8)
                assert torch.equal(a, b)
    torch.cuda.synchronize()


# --------------------------- K3 and K9 on s8 wgmma fed by TMA (dh 64) ----
# One persistent kernel (`csrc/attention_int8_wgmma.cuh`) for both, items
# of 128 query rows, 64-key tiles; K9's mask tile rides the K ring by TMA.
# The cases sit on and around the tiles' and items' edges; every launch's
# route is read from the route counters.


def _int8_took(before, kernel, want):
    """Since `before` (a `route_counts()`), `kernel`'s launches by route
    are `want` and no other routed kernel launched."""
    now = route_counts()
    for k, counts in now.items():
        got = {r: c - before[k][r] for r, c in counts.items()}
        assert got == (want if k == kernel else {r: 0 for r in counts}), (k, got)


@pytest.mark.parametrize("mask", [None, "bool", "additive", "additive_per_head",
                                  "bool_batch"])
@pytest.mark.parametrize("n", [63, 64, 65, 127, 129])
def test_k3_k9_wgmma_tile_edges(dev, mask, n):
    """K3 (no mask) and K9 at head size 64 on the wgmma route against their
    plain versions at the tile edges, bf16 and int8 out (`_int8_bars`);
    a bool mask's row 0 is fully masked: mean(V) over the N real keys; four
    launches, each on wgmma."""
    from msvit_tpu_torch.ops.packed_attention import int8_kernel_route

    assert int8_kernel_route(64) == "wgmma"
    q, sec = _int8(2, n, 12 * 64, dev, seed=70 + n)
    m = _k9_mask(mask, 2, 12, n, dev, seed=71 + n)
    before = route_counts()
    got, want, got_q, want_q = _k9_case(q, sec, 12, m)
    _int8_took(before, "K9", {"wgmma": 2, "mma.sync": 0, "cuda_cores": 0})
    _int8_bars(got, want, got_q, want_q)
    if mask is not None and mask.startswith("bool"):
        assert (got[:, 0].float() - _mean_v(q, sec)).abs().max().item() <= (
            2e-2 * want.float().abs().max().item())
    if mask is None:
        before = route_counts()
        with torch.inference_mode():
            got = packed_attention_int8(q, sec, 12)
            want = packed_attention_int8_plain(q, sec, 12)
            inv = 127.0 / want.float().abs().amax()
            got_q = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True)
            want_q = packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv, int8_out=True)
        torch.cuda.synchronize()
        _int8_took(before, "K3", {"wgmma": 2, "mma.sync": 0, "cuda_cores": 0})
        _int8_bars(got, want, got_q, want_q)


@pytest.mark.parametrize("dh", [32, 128])
def test_k3_k9_other_head_sizes_take_mma_sync(dev, dh):
    """dh 32 and 128 stay on the mma.sync kernel, K3 and K9 alike."""
    from msvit_tpu_torch.ops.packed_attention import int8_kernel_route

    assert int8_kernel_route(dh) == "mma.sync"
    h = 256 // dh
    q, sec = _int8(2, 130, h * dh, dev, seed=72 + dh)
    before = route_counts()
    _int8_bars(*_k9_case(q, sec, h, _k9_mask("additive", 2, h, 130, dev, seed=73)))
    _int8_took(before, "K9", {"wgmma": 0, "mma.sync": 2, "cuda_cores": 0})
    before = route_counts()
    with torch.inference_mode():
        packed_attention_int8(q, sec, h)
    torch.cuda.synchronize()
    _int8_took(before, "K3", {"wgmma": 0, "mma.sync": 1, "cuda_cores": 0})


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_k3_k9_wgmma_same_bits_twice(dev, mask):
    """Two calls on the wgmma route at a ragged N give the same bits (no
    atomics; a lane's and its quad's sums in a fixed order), bf16 and int8
    out."""
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked

    q, sec = _int8(3, 129, 12 * 64, dev, seed=74)
    m = _k9_mask(mask, 3, 12, 129, dev, seed=75)
    with torch.inference_mode():
        for out8 in (False, True):
            inv = torch.tensor(3.0, device=dev) if out8 else None
            runs = [packed_attention_int8_masked(q, sec, 12, mask=m, out_inv_scale=inv,
                                                 int8_out=out8) for _ in range(2)]
            assert torch.equal(*runs)
            if mask is None:
                runs = [packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=out8)
                        for _ in range(2)]
                assert torch.equal(*runs)
    torch.cuda.synchronize()


def test_k3_k9_wgmma_refuse_a_misaligned_qkv(dev):
    """A qkv_q whose base is off 16 bytes raises a ValueError on the wgmma
    route, K3 and K9 alike; it is not copied and nothing launches."""
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked

    flat = torch.zeros(8 + 2 * 5 * 3 * 128, dtype=torch.int8, device=dev)
    q = flat[8:].view(2, 5, 3 * 128)
    sec = torch.full((3,), 0.01, device=dev)
    before = route_counts()
    with pytest.raises(ValueError, match="aligned"):
        packed_attention_int8(q, sec, 2)
    with pytest.raises(ValueError, match="aligned"):
        packed_attention_int8_masked(q, sec, 2, mask=torch.zeros(2, 1, 5, 5, device=dev))
    _int8_took(before, None, {})


# ------------------------------------------------------------------ K10


def _banded_case(sizes, c, h, dh, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    cid = torch.cat([torch.full((s,), i) for i, s in enumerate(sizes)])[None]
    n = cid.shape[1]
    qkv = torch.randn(1, 2 * c + n, 3 * h * dh, generator=g).to(dtype)
    return qkv.to(dev), cid.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,c,h,dh", [
    ([10, 2, 12], 4, 2, 8),
    ([150, 100, 50], 4, 2, 64),  # clusters across 64-row blocks
    ([500, 400, 200, 100, 3], 8, 3, 32),
    ([1], 1, 2, 128),
    ([64, 64, 1, 171], 16, 2, 16),
    ([70, 0, 58], 4, 12, 64),  # an empty cluster
])
def test_k10_matches_plain(dev, dtype, sizes, c, h, dh):
    """K10 against its plain version (both round p to the compute dtype
    into l and P.V; f32 sums in another order): bf16 2e-2, f32 5e-5, of
    max(1, max |plain|)."""
    from msvit_tpu_torch.ops import banded_attention as ba

    qkv, cid = _banded_case(sizes, c, h, dh, dtype, dev, seed=57)
    before = ba.token_rows.launches
    with torch.inference_mode():
        got = ba.token_rows(qkv, cid, h, c)
        want = ba.token_rows_plain(qkv, cid, h, c)
    torch.cuda.synchronize()
    assert ba.token_rows.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    tol = _TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _banded_images(partitions, c, h, dh, dtype, dev, seed):
    """qkv [B, 2C + N, 3D] (the q third pre-scaled) and cid [B, N] from one
    partition (cluster sizes) per image, each of N tokens."""
    g = torch.Generator().manual_seed(seed)
    cid = torch.stack([torch.cat([torch.full((s,), i) for i, s in enumerate(sizes)])
                       for sizes in partitions])
    b, n = cid.shape
    qkv = torch.randn(b, 2 * c + n, 3 * h * dh, generator=g)
    qkv[..., :h * dh] *= dh**-0.5
    return qkv.to(dtype).to(dev), cid.to(dev)


# (partition of each image, clusters C, heads): N 63, 65 and 129; cluster
# boundaries inside and on 16- and 64-key blocks, one-token clusters, one
# cluster holding every token; the 448-px trunk at one cluster
_K10_EDGES = [
    ([[63], [20, 1, 42]], 16, 2),
    ([[16, 1, 48], [64, 1]], 16, 2),
    ([[64, 17, 1, 47], [5, 11, 16, 33, 64]], 16, 2),
    ([[129], [1] * 15 + [114]], 16, 2),
]


def _k10_case(qkv, cid, h, c):
    """K10 against its plain version: one launch, on `kernel_route`'s route
    (wgmma at bf16 head size 64), within K1's bar of max(1, max |plain|).
    Returns the kernel's output."""
    from msvit_tpu_torch.ops import banded_attention as ba

    before = route_counts()
    with torch.inference_mode():
        got = ba.token_rows(qkv, cid, h, c)
        want = ba.token_rows_plain(qkv, cid, h, c)
    torch.cuda.synchronize()
    _took(before, {"K10": kernel_route(qkv.dtype, qkv.shape[-1] // (3 * h))})
    assert got.shape == want.shape and got.dtype == qkv.dtype
    assert torch.isfinite(got).all()
    tol = _TOL[qkv.dtype] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    return got


@pytest.mark.parametrize("dh", [16, 32, 40, 64, 128])
@pytest.mark.parametrize("case", range(len(_K10_EDGES)))
def test_k10_bf16_tile_edges(dev, case, dh):
    """bf16 K10 on the tensor cores where its tiles have edges (rows and
    keys past N, the band's first and last tiles, 16-key blocks that a warp
    skips or takes, 64-key tiles that one warpgroup of an item skips and
    the other takes, the RX tile of C = 16 keys), at head sizes 16-128 (64
    on wgmma, the others on mma.sync; 40 runs the mma.sync kernel of the
    64 bucket, which serves head sizes 33-63), against its plain version:
    K1's bar of max(1, max |plain|)."""
    partitions, c, h = _K10_EDGES[case]
    qkv, cid = _banded_images(partitions, c, h, dh, torch.bfloat16, dev, seed=87 + case)
    _k10_case(qkv, cid, h, c)


def test_k10_bf16_one_cluster_at_448(dev):
    """bf16 K10 at the 448-px trunk's width before its first clustering
    event, [2, 32+3136, 2304] with every token in one cluster (the band is
    every key): against its plain version at K1's bar."""
    from msvit_tpu_torch.ops import banded_attention as ba

    qkv, cid = _banded_images([[3136]] * 2, 16, 12, 64, torch.bfloat16, dev, seed=91)
    with torch.inference_mode():
        got = ba.token_rows(qkv, cid, 12, 16)
        want = ba.token_rows_plain(qkv, cid, 12, 16)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = _TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_deterministic(dev, dtype):
    """No atomics: two calls of K10 give the same bits."""
    from msvit_tpu_torch.ops import banded_attention as ba

    qkv, cid = _banded_images([[64, 17, 1, 47, 200], [329]], 8, 3, 64, dtype, dev, seed=92)
    with torch.inference_mode():
        a, b = (ba.token_rows(qkv, cid, 3, 8) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _k10_sizes(n, k, seed):
    """`k` cluster sizes (each >= 1) summing to n, drawn from a seed."""
    g = torch.Generator().manual_seed(seed)
    cuts = torch.randperm(n - 1, generator=g)[:k - 1].sort().values + 1
    return torch.diff(torch.cat([torch.zeros(1), cuts.float(), torch.full((1,), n)])).long().tolist()


# (partition of each image, clusters C, heads) on K10's wgmma route: 9
# clusters at 448 px and at 224 px, different partitions per image, one
# cluster, one-token clusters, N off 128 (3136 is 24.5 items of 128 rows),
# C = 65 (two RX tiles, ids past 64 in use), C = 16 with 3 clusters used
_K10_WGMMA = [
    ([_k10_sizes(3136, 9, 1), _k10_sizes(3136, 9, 2)], 16, 12),
    ([_k10_sizes(784, 9, 3), _k10_sizes(784, 5, 4)], 16, 12),
    ([[3136], [3136]], 16, 12),
    ([[1] * 40 + [60, 1, 1, 98], [200]], 48, 2),
    ([_k10_sizes(300, 65, 5), [1] * 64 + [236]], 65, 2),
    ([[100, 1, 9], [1, 1, 108]], 16, 3),
]


@pytest.mark.parametrize("case", range(len(_K10_WGMMA)))
def test_k10_wgmma_partitions(dev, case):
    """K10 on the wgmma route (bf16, head size 64) against its plain
    version at the trunk's partitions and its edges (`_K10_WGMMA`); two
    calls give the same bits."""
    from msvit_tpu_torch.ops import banded_attention as ba

    partitions, c, h = _K10_WGMMA[case]
    qkv, cid = _banded_images(partitions, c, h, 64, torch.bfloat16, dev, seed=70 + case)
    got = _k10_case(qkv, cid, h, c)
    with torch.inference_mode():
        assert torch.equal(got, ba.token_rows(qkv, cid, h, c))


def test_k10_wgmma_refuses_a_qkv_tma_cannot_map(dev):
    """A bf16 qkv whose base is off 16 bytes raises on K10's wgmma route,
    naming the wrapper; nothing launches.  At head size 32 (mma.sync) the
    same layout is copied and runs."""
    from msvit_tpu_torch.ops import banded_attention as ba

    for dh, refused in ((64, True), (32, False)):
        flat = torch.zeros(1 + 2 * (2 + 70) * 3 * 2 * dh, dtype=torch.bfloat16, device=dev)
        qkv = flat[1:].view(2, 2 + 70, 3 * 2 * dh)
        cid = torch.zeros(2, 70, dtype=torch.long, device=dev)
        before = route_counts()
        with torch.inference_mode():
            if refused:
                with pytest.raises(ValueError, match="token_rows: TMA"):
                    ba.token_rows(qkv, cid, 2, 1)
            else:
                ba.token_rows(qkv, cid, 2, 1)
        torch.cuda.synchronize()
        _took(before, {} if refused else {"K10": "mma.sync"})


def test_k10_grad_and_bad_inputs(dev):
    """Under autograd K10 runs in TokenRowsFunction (one launch), its
    gradient the plain version's; bad inputs raise."""
    from msvit_tpu_torch.ops import banded_attention as ba

    qkv, cid = _banded_case([30, 40], 2, 2, 16, torch.float32, dev, seed=58)
    x = qkv.clone().requires_grad_()
    w = torch.randn(1, 70, 32, generator=torch.Generator().manual_seed(59)).to(dev)
    before = ba.token_rows.launches
    (ba.token_rows(x, cid, 2, 2) * w).sum().backward()
    torch.cuda.synchronize()
    assert ba.token_rows.launches == before + 1
    xp = qkv.clone().requires_grad_()
    (ba.token_rows_plain(xp, cid, 2, 2) * w).sum().backward()
    assert (x.grad - xp.grad).abs().max().item() <= 1e-4
    with torch.inference_mode():
        with pytest.raises(ValueError, match="cid"):
            ba.token_rows(qkv, cid[:, :50], 2, 2)
        with pytest.raises(TypeError):
            ba.token_rows(qkv.half(), cid, 2, 2)
        with pytest.raises(ValueError, match="head size"):
            ba.token_rows(qkv[..., :36], cid, 2, 2)
        with pytest.raises(ValueError, match="another device"):
            ba.token_rows(qkv, cid.cpu(), 2, 2)


# ------------------------------------- the grouped regime (K8a, K8b) ----
# K1, K1-lse and K2 at the shapes of the TPU's head-grouped functions
# (`_packed_forward_grouped`, `_packed_backward_grouped`), which they stand
# for: 785 tokens unmasked, the soft-masked 816, masked f32 at 197, odd N.


def _grouped_mask(kind, b, h, n, dev, seed):
    r = torch.rand(b, h, n, n, generator=torch.Generator().manual_seed(seed))
    if kind == "bool":
        m = r < 0.7
        m[:, :, 0, :] = False
        return m.to(dev)
    if kind == "additive":
        return (-100.0 * (r < 0.3).float()).to(dev)
    return None


@pytest.mark.parametrize("b,n,dtype,mask,mask_heads", [
    (4, 785, torch.bfloat16, None, 1),
    (4, 785, torch.float32, None, 1),
    (2, 816, torch.bfloat16, "additive", 1),
    (2, 816, torch.bfloat16, "bool", 1),
    (4, 197, torch.float32, "additive", 12),
    (2, 1025, torch.bfloat16, None, 1),
    (2, 531, torch.bfloat16, "additive", 12),
])
def test_grouped_regime_k1_k1_lse_k2_match_plain(dev, b, n, dtype, mask, mask_heads):
    m = _grouped_mask(mask, b, mask_heads, n, dev, seed=40)
    _train_case(b, n, 12, 64, dtype, dev, seed=41, mask=m)
    x = _qkv(b, n, 768, dtype, dev, seed=42)
    with torch.inference_mode():
        got = packed_attention(x, 12, mask=m)
        want = packed_attention_plain(x, 12, mask=m)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _TOL[dtype]


def test_k2_reads_the_additive_mask_in_f32(dev):
    """The TPU's grouped backward rounds an additive mask to bf16; the
    port's K2 reads it in f32, as its plain version does: with -3.3 (bf16:
    -3.296875) the kernel equals the plain version on the f32 mask."""
    b, n, h, dh = 2, 197, 12, 64
    r = torch.rand(b, h, n, n, generator=torch.Generator().manual_seed(43))
    _train_case(b, n, h, dh, torch.float32, dev, seed=44,
                mask=(-3.3 * (r < 0.5).float()).to(dev))


def test_clip_on_the_card(dev):
    """The clip is formed on the device: the clipped gradients' global norm
    is min(norm, clip), with no host synchronization in the step."""
    from msvit_tpu_torch.train import make_optimizer, train_step_fn

    model = torch.nn.Linear(16, 4).to(dev)
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(45)).to(dev)

    def loss_fn(m, batch, gen):
        return (m(batch) ** 2).sum() * 50.0, {}

    opt = make_optimizer(1e-3, clip_norm=0.25)
    state = opt.init(model)
    step = train_step_fn(loss_fn, opt, monitor=True)
    step(model, state, x, None)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, aux = step(model, state, x, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    left = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    assert float(aux["grad_norm"]) > 0.25
    assert abs(float(left) - 0.25) <= 1e-5


def test_prefetch_on_the_card(dev):
    """Pinned staging and a side-stream copy: order and values kept, the
    ring's buffers reused, tensors on the card, the worker stopped."""
    import threading

    import numpy as np

    from msvit_tpu_torch.data.pipeline import prefetch_to_device

    items = [{"pixel_values": np.full((4, 8, 8, 3), i, np.uint8),
              "labels": np.arange(4, dtype=np.int32) + i} for i in range(9)]
    it = prefetch_to_device(
        iter(items), buffer_size=2, device=dev,
        transform=lambda d: {**d, "pixel_values": d["pixel_values"].float() / 127.5 - 1.0})
    for i, batch in enumerate(it):
        assert batch["pixel_values"].is_cuda and batch["labels"].is_cuda
        want = i / 127.5 - 1.0
        assert (batch["pixel_values"].mean().item() - want) ** 2 < 1e-10
        assert batch["labels"].tolist() == list(range(i, i + 4))
    assert i == 8
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------ subsample and saccadic


def test_subsample_deep_trunk_runs_k7_with_its_key_only_mask(dev):
    """The subsample model at 448 px and depth 3 (1,361 tokens) at a small
    width, f32: open mode runs K7 in every layer of its 4 iterations, freeze
    mode in its last one (Nq 1025 against 1361 keys), both with the key-only
    mask; with every slot split (policy bias +20: one tree on both paths)
    the outputs equal the plain attention path's within 1e-4."""
    import dataclasses

    from msvit_tpu_torch.models.subsample import SubsampleViTConfig, SubsampleViTModel
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.settings import parity_policy

    pix = torch.randn(2, 448, 448, 3, generator=torch.Generator().manual_seed(97)).to(dev)
    for mode, want in (("open", 8), ("freeze", 2)):
        cfg = SubsampleViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=448, patch_size=16, max_depth=3, nesting_mode=mode,
                                 policy=parity_policy())
        outs = []
        for impl in ("auto", "xla"):
            model = SubsampleViTModel(dataclasses.replace(cfg, attn_implementation=impl),
                                      generator=torch.Generator().manual_seed(0),
                                      device=dev).eval()
            model.projection.bias.data.fill_(20.0)
            before = fl.flash_attention.launches
            with torch.inference_mode():
                outs.append(model(pix, rng=5))
            assert fl.flash_attention.launches - before == (want if impl == "auto" else 0)
        a, b = outs
        assert torch.equal(a["last_valid_mask"], b["last_valid_mask"])
        assert int(a["last_valid_mask"].sum()) == 2 * 1024
        assert (a["last_hidden_state"] - b["last_hidden_state"]).abs().max().item() <= 1e-4


def test_subsample_and_saccadic_entry_points_run_on_the_card(dev, tmp_path, monkeypatch):
    """The subsample and saccadic examples run on the card unless the
    caller asks for the CPU (`--device cpu`).  The subsample example's
    corpus is made in memory (`generate_batch`, as `chip_smoke.py` does):
    its JPEG route decodes with the native libjpeg decoder, which a machine
    without libjpeg's header cannot build (it raises there, as the JAX
    package's does), and the decode is host work, not the card's."""
    from msvit_tpu_torch.data.synthetic import generate_batch
    from msvit_tpu_torch.examples import saccadic_demo, train_saccadic
    from msvit_tpu_torch.examples import train_subsample_synthetic as subsample
    from msvit_tpu_torch.models.saccadic import SaccadicViTConfig
    from msvit_tpu_torch.models.subsample import SubsampleViTConfig

    def in_memory(out_dir, num_images, size, seed, label_mode, max_objects):
        return generate_batch(range(seed, seed + num_images), size=size, label_mode=label_mode,
                              max_objects=max_objects)

    monkeypatch.setattr(subsample, "ensure_corpus", in_memory)

    scfg = SubsampleViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                              image_size=32, patch_size=8, initial_grid_size=2, max_depth=2,
                              num_labels=10)
    args = ["--warmup", "1", "--steps", "1", "--batch", "4", "--corpus-size", "8",
            "--eval-size", "8", "--out", str(tmp_path), "--no-figure"]  # no matplotlib there
    assert subsample.main(args, config=scfg)["device"] == "cuda"
    assert subsample.main(args + ["--device", "cpu"], config=scfg)["device"] == "cpu"
    acfg = SaccadicViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                             num_patterns=((1, 8), (2, 8)), covariance_dim=4, beam_size=4,
                             image_size=64, patch_size=16)
    assert saccadic_demo.main([], config=acfg)["device"] == "cuda"
    assert saccadic_demo.main(["--device", "cpu"], config=acfg)["device"] == "cpu"
    small = ["--steps", "1", "--batch", "2", "--glimpses", "3", "--context", "1"]
    assert train_saccadic.main(small, config=acfg)["device"] == "cuda"
    assert train_saccadic.main(small + ["--device", "cpu"], config=acfg)["device"] == "cpu"


def test_subsample_example_jpeg_corpus_route_on_the_card(dev, tmp_path):
    """The subsample example's default route, unpatched: it writes a JPEG
    corpus and decodes it with the native libjpeg decoder, which builds on
    a machine without a system libjpeg by linking the one Pillow's wheel
    bundles (`native.link_args`).  The route runs on the card and its
    decoder is the native one (no PIL fallback)."""
    from msvit_tpu_torch import native
    from msvit_tpu_torch.examples import train_subsample_synthetic as subsample
    from msvit_tpu_torch.models.subsample import SubsampleViTConfig

    scfg = SubsampleViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                              image_size=32, patch_size=8, initial_grid_size=2, max_depth=2,
                              num_labels=10)
    args = ["--warmup", "1", "--steps", "1", "--batch", "4", "--corpus-size", "8",
            "--eval-size", "8", "--out", str(tmp_path), "--no-figure"]
    assert native.build("decode").exists()
    before = native.decode_resize_u8.calls + native.decode_preprocess_batch.calls
    assert subsample.main(args, config=scfg)["device"] == "cuda"
    assert native.decode_resize_u8.calls + native.decode_preprocess_batch.calls > before


def test_reloaded_k1_k3_artifacts_equal_the_live_model(dev):
    """The export round trip on the card: a 2-layer ViT at 224 px (197
    tokens, dh 64, bf16 compute) exported with a polymorphic batch, bf16 (K1
    as a registered op) and int8 calibrated (K3), reloaded from bytes: at
    b = 1, 2 and 5 each equals the live forward element for element (the
    same kernels on the same inputs) and launches its kernel once per
    layer."""
    from msvit_tpu_torch.export import export_forward, load_forward
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)

    cfg = BaseViTConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2)
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    g = torch.Generator().manual_seed(1)
    pix = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    qparams = quantize_vit_params(model)
    scales = calibrate_act_scales(qparams, cfg, torch.randn(8, 224, 224, 3, generator=g).to(dev))

    def bf16(p, x):
        return torch.func.functional_call(model, p, (x,))["last_hidden_state"]

    def int8(p, x):
        return quantized_vit_apply(p["w"], cfg, x, act_scales=p["s"])

    cases = [(bf16, params, packed_attention), (int8, {"w": qparams, "s": scales},
                                                packed_attention_int8)]
    for fn, p, kernel in cases:
        reloaded = load_forward(export_forward(fn, (p, pix), polymorphic_batch=True))
        for b in (1, 2, 5):
            x = torch.randn(b, 224, 224, 3, generator=g).to(dev)
            before = kernel.launches
            got = reloaded(p, x)
            assert kernel.launches == before + 2
            with torch.no_grad():
                want = fn(p, x)
            torch.cuda.synchronize()
            assert got.shape == (b, 197, 128) and torch.equal(got, want)


# ------------------------------------------------------- base extras' shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h", [(4, 197, 10), (2, 1370, 12)])
def test_k1_at_the_extras_shapes(dev, dtype, b, n, h):
    """K1 after `prune_heads` (H 12 -> 10: 3 H dh = 1920, not 3 D) and at
    DINOv2-B/14's 1,370 tokens (518 px), against its plain version."""
    x = _qkv(b, n, h * 64, dtype, dev, seed=71)
    before = packed_attention.launches
    with torch.inference_mode():
        got = packed_attention(x, h)
        want = packed_attention_plain(x, h)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert got.shape == (b, n, h * 64)
    assert (got.float() - want.float()).abs().max().item() <= _TOL[dtype]


def test_k3_after_prune_heads(dev):
    """K3 at H 10 (qkv [4, 197, 1920]), bf16 and int8 out."""
    q, sec = _int8(4, 197, 10 * 64, dev, seed=72)
    with torch.inference_mode():
        got = packed_attention_int8(q, sec, 10)
        want = packed_attention_int8_plain(q, sec, 10)
        inv = 127.0 / want.float().abs().amax()
        got_q = packed_attention_int8(q, sec, 10, out_inv_scale=inv, int8_out=True)
        want_q = packed_attention_int8_plain(q, sec, 10, out_inv_scale=inv, int8_out=True)
    torch.cuda.synchronize()
    assert got.shape == (4, 197, 640)
    _int8_bars(got, want, got_q, want_q)


def test_moe_and_pruned_trunks_on_the_card(dev):
    """A 2-layer MoE trunk (dispatch, capacity 1.25) and a pruned one
    (4 -> 3 heads) against the plain attention path on the card (bf16),
    and the pruned trunk's int8 apply (K3 at 3 H' dh = 384)."""
    import dataclasses

    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.pruning import prune_heads
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)

    g = torch.Generator().manual_seed(73)
    pix = torch.randn(4, 224, 224, 3, generator=g).to(dev)
    cos = torch.nn.functional.cosine_similarity
    base = BaseViTConfig(hidden_size=256, num_hidden_layers=2, num_attention_heads=4)
    moe = dataclasses.replace(base, num_experts=4)
    pruned_state, pruned = prune_heads(ViTModel(base).state_dict(), base,
                                       {0: [1], 1: [2]})
    for cfg, state in ((moe, ViTModel(moe).state_dict()), (pruned, pruned_state)):
        outs = []
        for impl in ("auto", "xla"):
            m = ViTModel(dataclasses.replace(cfg, attn_implementation=impl), device=dev).eval()
            m.load_state_dict(state)
            with torch.inference_mode():
                outs.append(m(pix)["last_hidden_state"].float())
        assert torch.isfinite(outs[0]).all()
        assert cos(outs[0].flatten(1), outs[1].flatten(1)).min().item() >= 0.999
    qp = quantize_vit_params(m)
    scales = calibrate_act_scales(qp, pruned, pix)
    before = packed_attention_int8.launches
    got = quantized_vit_apply(qp, pruned, pix, act_scales=scales).float()
    torch.cuda.synchronize()
    assert packed_attention_int8.launches == before + 2
    assert cos(got.flatten(1), outs[1].flatten(1)).min().item() >= 0.98


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,dh,mask", [(260, 4, 64, "tail"), (200, 4, 40, "random"),
                                         (384, 2, 64, "tail"), (129, 3, 32, None)])
def test_ring_blocks_match_dense_k7(dev, dtype, n, s, dh, mask):
    """Ring attention's per-block steps (K7-lse and the lse merge forward,
    K6 with the global out and lse backward), every rank's ring in one
    process, against `FlashAttentionFunction` (K7-lse, K6) on the whole
    sequence: blocks of 65, 50, 192 and 43 tokens (ragged 64-row tiles), a
    padding tail that blanks the last block of image 0, random key masks.
    f32: 1e-4 of the largest value; bf16: 2e-2 (each block's output is
    rounded to bf16 before the merge)."""
    from msvit_tpu_torch.ops.flash_attention import (
        FlashAttentionFunction, flash_attention_bwd, flash_attention_lse)
    from msvit_tpu_torch.parallel.ring_attention import ring_attention_single_process

    b, h = 2, 3
    g = torch.Generator().manual_seed(n)
    q, k, v, gout = (torch.randn(b, n, h, dh, generator=g).to(dtype).to(dev) for _ in range(4))
    m = None
    if mask == "tail":
        m = torch.ones(b, n, dtype=torch.bool)
        m[0, (s - 1) * (n // s):] = False
        m[1, n - 7:] = False
    elif mask == "random":
        m = torch.rand(b, n, generator=g) < 0.8
        m[:, 0] = True
    m = None if m is None else m.to(dev)
    before = (flash_attention_lse.launches, flash_attention_bwd.launches)
    out, grads = ring_attention_single_process(q, k, v, s, m, gout)
    torch.cuda.synchronize()
    assert (flash_attention_lse.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (s * s, s * s)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    want = FlashAttentionFunction.apply(qt, kt, vt, None if m is None else m[:, None, None, :],
                                        dh ** -0.5, -0.7 * float(torch.finfo(torch.float32).max))
    want_grads = torch.autograd.grad(want, (qt, kt, vt), gout.transpose(1, 2))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in [(out, want)] + list(zip(grads, want_grads)):
        ref = ref.transpose(1, 2).float()
        assert (got.float() - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())
    if mask == "tail":  # the blank block's keys get no gradient
        assert not grads[1][0, (s - 1) * (n // s):].any()


def test_nccl_world_size_one_step(dev, tmp_path):
    """The sharded step over NCCL at world size 1 (an in-process group, a
    `file://` store): data parallel, ZeRO-1 and FSDP, two AdamW steps of a
    small ViT in f32 each, equal to the `Trainer`'s unsharded steps (a group
    of one sums nothing: 1e-6), K1-lse and K2 launched once a layer a step;
    then the group is destroyed."""
    import copy

    import torch.distributed as dist
    import torch.nn.functional as F

    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
    from msvit_tpu_torch.parallel import distributed as pdist
    from msvit_tpu_torch.parallel.mesh import make_mesh
    from msvit_tpu_torch.parallel.train_step import make_sharded_train_step
    from msvit_tpu_torch.settings import parity_policy
    from msvit_tpu_torch.train import Trainer, make_optimizer

    def loss_fn(model, batch, gen):
        return F.cross_entropy(model(batch[0]), batch[1]), {}

    cfg = BaseViTConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        image_size=64, patch_size=16, policy=parity_policy())
    base = ViTForImageClassification(cfg, 10, generator=torch.Generator().manual_seed(0),
                                     device=dev)
    g = torch.Generator().manual_seed(1)
    batch = (torch.randn(8, 64, 64, 3, generator=g).to(dev),
             torch.randint(0, 10, (8,), generator=g).to(dev))
    ref = copy.deepcopy(base)
    tr = Trainer(loss_fn, make_optimizer(1e-3), ref)
    for i in range(2):
        tr.step_fn(ref, tr.opt_state, batch, torch.Generator().manual_seed(i))
    want = ref.state_dict()
    pdist.initialize(init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                     backend="nccl")
    try:
        mesh = make_mesh(tp=1)
        for mode in ({}, {"zero1": True}, {"fsdp": True}):
            model = copy.deepcopy(base)
            step, state = make_sharded_train_step(loss_fn, make_optimizer(1e-3), mesh, model,
                                                  **mode)
            for i in range(2):
                before = (packed_attention_lse.launches, packed_attention_bwd.launches)
                step(model, state, batch, torch.Generator().manual_seed(i))
                torch.cuda.synchronize()
                assert (packed_attention_lse.launches - before[0],
                        packed_attention_bwd.launches - before[1]) == (2, 2), mode
            got = model.state_dict()
            for key, w in want.items():
                t = got[key].full_tensor() if hasattr(got[key], "full_tensor") else got[key]
                assert (t - w).abs().max().item() <= 1e-6, (mode, key)
    finally:
        dist.destroy_process_group()


# ------------------------------------------- the registered ops (K4-K10)


def _op_cases(dev):
    """(op, args) of K5, K4 and K7 (a soft, a key-only and a bool mask; bf16
    and f32), K9 (soft mask; bf16 and int8 out) and K10 (bf16, f32) on CUDA
    tensors at odd shapes."""
    g = torch.Generator().manual_seed(81)
    b, h, nq, nk, dh = 2, 3, 37, 70, 64
    q, k, v = (torch.randn(b, h, n, dh, generator=g) for n in (nq, nk, nk))
    masks = [torch.where(torch.rand(b, 1, nq, nk, generator=g) < 0.7, 0.0, -100.0),
             torch.where(torch.rand(b, 1, 1, nk, generator=g) < 0.7, 0.0, -1e30),
             torch.rand(b, h, nq, nk, generator=g) < 0.7]
    cases = []
    for name in ("fused_attention", "fused_attention_inference", "flash_attention"):
        for m in masks:
            for dt in (torch.bfloat16, torch.float32):
                cases.append((getattr(torch.ops.msvit, name).default,
                              (q.to(dt).to(dev), k.to(dt).to(dev), v.to(dt).to(dev),
                               m.to(dev), dh**-0.5, -1e9)))
    qkv_q = torch.randint(-127, 128, (b, 41, 3 * h * dh), generator=g).to(torch.int8).to(dev)
    sec = torch.tensor([0.01, 0.02, 0.03], device=dev)
    soft = torch.where(torch.rand(b, 1, 41, 41, generator=g) < 0.7, 0.0, -100.0).to(dev)
    for inv in (None, torch.tensor(40.0, device=dev)):
        cases.append((torch.ops.msvit.packed_attention_int8_masked.default,
                      (qkv_q, sec, soft, inv, h, dh**-0.5, inv is not None, -1e9)))
    c, n = 4, 75
    cid = torch.sort(torch.randint(0, c, (b, n), generator=g), dim=1).values.to(dev)
    qkv = torch.randn(b, 2 * c + n, 3 * h * dh, generator=g) * 0.5
    for dt in (torch.bfloat16, torch.float32):
        cases.append((torch.ops.msvit.token_rows.default, (qkv.to(dt).to(dev), cid, h, c)))
    return cases


def test_registered_ops_pass_opcheck_on_the_card(dev):
    """`torch.library.opcheck` of K4, K5, K7, K9 and K10 on CUDA tensors
    (schema, the fake against the kernel, dispatch under a trace), and each
    fake's shape, dtype and strides against the kernel's output: K4, K5
    and K7 write a [B, Nq, H, dh] buffer seen as [B, H, Nq, dh]."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for op, args in _op_cases(dev):
        torch.library.opcheck(op, args)
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args])
        assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype,
                                                           real.stride()), op


def test_device_spans_resolve_to_device_ms(dev):
    """A `device=True` span times the device between its two CUDA events,
    not the host: a ~50-ms sleep kernel launched inside it returns at once
    on the host."""
    from msvit_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.reset()
    try:
        with profiling.record():
            with profiling.span("sleep", device=True):
                torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at 1.98 GHz
            with profiling.span("host"):
                pass
        sleep, host = profiling.spans()
        row = profiling.summary()
    finally:
        profiling.reset()
    host_ms = (sleep["end_ns"] - sleep["start_ns"]) / 1e6
    assert sleep["device_ms"] >= 20.0 and host_ms < sleep["device_ms"]
    assert "device_ms" not in host and row["sleep"]["device_ms"] == sleep["device_ms"]


def test_monitored_trainer_steps_make_no_host_sync_while_recording(dev):
    """Steps between log boundaries of a monitored `Trainer` run under
    `set_sync_debug_mode("error")` with spans recorded; each step's three
    phases carry device milliseconds."""
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
    from msvit_tpu_torch.train import Trainer, make_optimizer
    from msvit_tpu_torch.utils import profiling

    cfg = BaseViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                        image_size=32, patch_size=16)
    with torch.device(dev):
        model = ViTForImageClassification(cfg, 10, generator=torch.Generator(dev).manual_seed(0))

    def loss_fn(model, batch, generator):
        logits = model(batch["pixel_values"], generator=generator)
        return torch.nn.functional.cross_entropy(logits, batch["labels"]), {}

    g = torch.Generator(dev).manual_seed(1)
    batch = {"pixel_values": torch.randn(8, 32, 32, 3, generator=g, device=dev),
             "labels": torch.randint(0, 10, (8,), generator=g, device=dev)}
    trainer = Trainer(loss_fn, make_optimizer(1e-3), model, log_every=25, monitor=True)
    trainer.fit(iter([batch]), 1, seed=0)  # warm-up; its one step logs
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with profiling.record():
            torch.cuda.set_sync_debug_mode("error")
            try:
                trainer.fit(iter([batch] * 3), 100, seed=0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        got = profiling.spans()
    finally:
        profiling.reset()
    assert trainer.step == 4
    for phase in ("train.forward", "train.backward", "train.update"):
        ms = [s["device_ms"] for s in got if s["name"] == phase]
        assert len(ms) == 3 and min(ms) > 0, (phase, ms)
    assert not [s for s in got if s["name"].startswith(("train.log", "sync."))]
