"""The route rule of K1, K1-lse, K2, K4, K5, K5-lse, K6, K7, K7-lse and K10
and the geometry of the wgmma route's TMA maps
(`msvit_tpu_torch/ops/packed_attention.py`), kept in Python so that the CPU
can check them: bf16 at head size 64 takes the wgmma kernels, other bf16
head sizes the mma.sync kernels, f32 the CUDA cores; K1-lse's and K2's
maps are 3-D over the packed [B, N, W] tensors with a (64, 64, 1) box at
each head's q, k and v columns, those of K1, K4, K5, K6, K7 and K10 4-D
over [B, H, N, 64] views through their strides with a (64, 64, 1, 1) box
(K10's over the token rows and the RX rows of its packed qkv); K6's
cotangent is copied where that map cannot take it.  No JAX, no kernel: a
few milliseconds."""

import pytest
import torch

from msvit_tpu_torch.ops import packed_attention as pa


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 80, "mma.sync"),
    (torch.bfloat16, 128, "mma.sync"),
    (torch.bfloat16, 40, "mma.sync"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
])
def test_train_route(dtype, dh, route):
    assert pa.kernel_route(dtype, dh) == route


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 128, "mma.sync"),
    (torch.float32, 64, "cuda_cores"),
])
def test_fused_and_flash_entry_routes(dtype, dh, route):
    """The route of each C entry point of K4, K5, K5-lse, K7 and K7-lse:
    the one rule `kernel_route`, which `fused_attention._run` calls for all
    five (K4 with the shaved softmax): wgmma at bf16 head size 64, mma.sync
    at the other bf16 head sizes, the CUDA cores in f32."""
    from msvit_tpu_torch.ops import fused_attention as fa

    assert fa.kernel_route is pa.kernel_route
    assert fa.kernel_route(dtype, dh) == route


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError),
    (torch.int8, 64, TypeError),
    (torch.bfloat16, 12, ValueError),
    (torch.bfloat16, 136, ValueError),
    (torch.bfloat16, 0, ValueError),
])
def test_train_route_refuses(dtype, dh, error):
    with pytest.raises(error):
        pa.kernel_route(dtype, dh)


@pytest.mark.parametrize("shape,pitch", [((64, 197, 2304), 4608), ((64, 785, 2304), 4608),
                                         ((64, 197, 768), 1536), ((3, 5, 3 * 4 * 64), 1536)])
def test_tma_map_geometry(shape, pitch):
    """Dims innermost first, the row pitch W*2 and image pitch N*W*2 bytes,
    the (64, 64, 1) box of 8 KB (one 128-byte swizzled row a token)."""
    b, n, w = shape
    got = pa.tma_map(shape, 2, 4096)
    assert got == {"dims": (w, n, b), "pitches": (pitch, pitch * n), "box": (64, 64, 1),
                   "box_bytes": 8192}


@pytest.mark.parametrize("shape,ptr", [((2, 5, 192), 4098), ((2, 5, 12), 4096),
                                       ((1, 3, 60), 4096)])
def test_tma_map_refuses(shape, ptr):
    """A base off 16 bytes, a pitch that is not a multiple of 16 bytes."""
    with pytest.raises(ValueError, match="TMA"):
        pa.tma_map(shape, 2, ptr)


def test_check_tma_names_the_wrapper():
    x = torch.zeros(1 + 2 * 5 * 192, dtype=torch.bfloat16)[1:].view(2, 5, 192)
    assert x.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="packed_attention_lse: TMA"):
        pa._check_tma("packed_attention_lse", x)


@pytest.mark.parametrize("h", [0, 5, 11])
def test_head_columns_address_the_packed_sections(h):
    """The boxes' first columns h*dh, D + h*dh, 2D + h*dh hold head h's q,
    k and v as `unpack_qkv` reads them."""
    heads, dh = 12, 64
    x = torch.arange(2 * 3 * 3 * heads * dh, dtype=torch.float32).reshape(2, 3, -1)
    q, k, v = pa.unpack_qkv(x, heads)
    for c, t in zip(pa.head_columns(heads, h, dh), (q, k, v)):
        assert torch.equal(x[..., c:c + dh], t[:, h])


def test_route_counters_and_the_cpu_path():
    """The wrappers take the plain versions on the CPU and count no launch;
    `zero_counts` zeroes every route's count of the twelve kernels."""
    from msvit_tpu_torch.ops import banded_attention as ba
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import fused_attention as fa

    routed = (pa.packed_attention, pa.packed_attention_lse, pa.packed_attention_bwd,
              fa.fused_attention_inference, fa.fused_attention, fa.fused_attention_lse,
              fl.flash_attention_bwd, fl.flash_attention, fl.flash_attention_lse,
              ba.token_rows, pa.packed_attention_int8, pa.packed_attention_int8_masked)
    pa.packed_attention_lse.wgmma_launches = 3
    fl.flash_attention.mma_launches = 2
    fa.fused_attention.mma_launches = 4
    fl.flash_attention_bwd.wgmma_launches = 5
    ba.token_rows.wgmma_launches = 6
    pa.packed_attention_int8.wgmma_launches = 7
    pa.packed_attention_int8_masked.mma_launches = 8
    pa.zero_counts(*routed)
    x = torch.randn(1, 7, 3 * 2 * 64)
    out, lse = pa.packed_attention_lse(x, 2)
    pa.packed_attention_bwd(x, None, out, lse, torch.randn(1, 7, 128), 2)
    with torch.no_grad():
        pa.packed_attention(x, 2)
        q, k, v = pa.unpack_qkv(x, 2)
        fl.flash_attention(q, k, v)
        fl.flash_attention_lse(q, k, v)
        fa.fused_attention_inference(q, k, v)
        fa.fused_attention(q, k, v)
        o, lse = fa.fused_attention_lse(q, k, v)
        fl.flash_attention_bwd(q, k, v, o, torch.randn_like(o), lse)
        ba.token_rows(torch.randn(1, 2 + 7, 3 * 2 * 64), torch.zeros(1, 7, dtype=torch.long),
                      2, 1)
        xq = torch.randint(-127, 128, (1, 7, 3 * 2 * 64), dtype=torch.int8)
        sec = torch.tensor([0.01, 0.02, 0.03])
        pa.packed_attention_int8(xq, sec, 2)
        pa.packed_attention_int8_masked(xq, sec, 2, mask=torch.zeros(1, 1, 7, 7))
    zero = {r: 0 for r in pa.ROUTES}
    assert pa.route_counts() == {k: zero for k in ("K1", "K1-lse", "K2", "K3", "K4", "K5",
                                                   "K5-lse", "K6", "K7", "K7-lse", "K9",
                                                   "K10")}
    assert all(fn.launches == 0 for fn in routed)


def _view(kind, b=2, n=197, h=3):
    """A [B, H, N, 64] bf16 view of each layout the wgmma route of K1 and
    K7 reads: K1's and the 448-px trunk's q/k/v of a packed [B, N, 3D] QKV
    output, a contiguous tensor (tests, the ring's q), the ring's k and v
    ([B, N, H, 64] transposed)."""
    if kind == "packed":
        return pa.unpack_qkv(torch.zeros(b, n, 3 * h * 64, dtype=torch.bfloat16), h)[1]
    if kind == "contiguous":
        return torch.zeros(b, h, n, 64, dtype=torch.bfloat16)
    return torch.zeros(b, n, h, 64, dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("kind,pitches", [
    ("packed", (3 * 3 * 128, 128, 197 * 3 * 3 * 128)),
    ("contiguous", (128, 197 * 128, 3 * 197 * 128)),
    ("transposed", (3 * 128, 128, 197 * 3 * 128)),
])
def test_tma_map_heads_geometry(kind, pitches):
    """Dims (64, N, H, B) innermost first, the row, head and image pitches
    of each layout (the packed views' head pitch is 128 bytes, below the
    row pitch), the (64, 64, 1, 1) box of 8 KB."""
    t = _view(kind)
    got = pa.tma_map_heads(t.shape, t.stride(), 2, 4096)
    assert got == {"dims": (64, 197, 3, 2), "pitches": pitches, "box": (64, 64, 1, 1),
                   "box_bytes": 8192}


def test_tma_map_heads_size_one_dims_are_not_stepped():
    """A dim of size 1 takes the pitch below it times that dim's size,
    whatever its stride (here 0 and 8 elements), as `map_heads` does."""
    got = pa.tma_map_heads((1, 1, 5, 64), (8, 0, 64, 1), 2, 4096)
    assert got["pitches"] == (128, 5 * 128, 5 * 128)
    assert pa.tma_map_heads((2, 3, 1, 64), (3 * 64, 64, 0, 1), 2, 4096)["pitches"] == (
        128, 128, 3 * 128)


@pytest.mark.parametrize("shape,strides,ptr,what", [
    ((2, 3, 5, 64), (960, 320, 64, 1), 4104, "base"),  # off 16 bytes
    ((2, 3, 5, 64), (1020, 340, 68, 1), 4096, "row pitch"),  # 136 bytes
    ((2, 3, 5, 64), (960, 0, 64, 1), 4096, "head pitch"),  # expanded over heads
    ((2, 3, 5, 64), (960, 64, 192, 2), 4096, "contiguous"),  # every other element
])
def test_tma_map_heads_refuses(shape, strides, ptr, what):
    with pytest.raises(ValueError, match=f"TMA: .*{what}"):
        pa.tma_map_heads(shape, strides, 2, ptr)


def test_check_tma_heads_names_the_wrapper():
    x = torch.zeros(1 + 2 * 3 * 5 * 64, dtype=torch.bfloat16)[1:].view(2, 3, 5, 64)
    assert x.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="flash_attention: TMA"):
        pa.check_tma_heads("flash_attention", x)


@pytest.mark.parametrize("h", [0, 5, 11])
def test_k1_views_read_the_packed_columns(h):
    """K1's 4-D maps over the q, k and v views of a packed qkv address the
    columns of K1-lse's 3-D map: a row of head h's view at image i is the
    packed row's 64 elements at h*64, D + h*64, 2D + h*64, and the views'
    pitches are the packed row's (3D*2 bytes) and image's."""
    heads, n = 12, 7
    x = torch.arange(2 * n * 3 * heads * 64, dtype=torch.float32).reshape(2, n, -1)
    views = pa.unpack_qkv(x, heads)
    for c, t in zip(pa.head_columns(heads, h), views):
        assert t.stride() == (n * 3 * heads * 64, 64, 3 * heads * 64, 1)
        assert t.data_ptr() - x.data_ptr() == (c - h * 64) * x.element_size()
        assert torch.equal(t[:, h], x[..., c:c + 64])


def _cotangent(kind):
    """K6's cotangent [2, 3, 5, 64] bf16 as autograd can hand it over."""
    if kind == "transposed":  # the gradient through the [B, N, H, 64] output
        return torch.randn(2, 5, 3, 64).to(torch.bfloat16).transpose(1, 2)
    if kind == "contiguous":
        return torch.randn(2, 3, 5, 64).to(torch.bfloat16)
    if kind == "expanded":  # the gradient of (out * w).sum(), w of shape [64]
        return torch.randn(64).to(torch.bfloat16).expand(2, 3, 5, 64)
    # rows 68 elements apart: a 136-byte pitch
    return torch.randn(2, 3, 5, 68).to(torch.bfloat16)[..., :64]


@pytest.mark.parametrize("kind,copied", [("transposed", False), ("contiguous", False),
                                         ("expanded", True), ("unaligned_rows", True)])
def test_k6_cotangent_is_copied_only_where_tma_refuses_it(kind, copied):
    """`tma_heads_operand` hands K6's wgmma route the cotangent as it is
    where the 4-D TMA map takes it, and a contiguous copy, which the map
    takes, where it does not: strides (0, 0, 0, 1) (pitch 0) or a pitch off
    16 bytes.  The values never change."""
    g = _cotangent(kind)
    refused = False
    try:
        pa.tma_map_heads(g.shape, g.stride(), 2, g.data_ptr())
    except ValueError:
        refused = True
    got = pa.tma_heads_operand(g)
    assert refused == copied and (got is not g) == copied
    assert torch.equal(got, g)
    pa.tma_map_heads(got.shape, got.stride(), 2, got.data_ptr())


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 128, "mma.sync"),
    (torch.float32, 64, "cuda_cores"),
])
def test_k10_route(dtype, dh, route):
    """K10's wrapper takes `kernel_route`'s route, as its C entry point
    does (bf16 at head size 64: banded_wgmma_kernel), and a launch counted
    on it shows in `route_counts()["K10"]` under that route alone."""
    from msvit_tpu_torch.ops import banded_attention as ba

    assert pa.kernel_route(dtype, dh) == route
    pa.zero_counts(ba.token_rows)
    try:
        pa._count_route(ba.token_rows, pa.kernel_route(dtype, dh))
        assert pa.route_counts()["K10"] == {r: int(r == route) for r in pa.ROUTES}
        assert ba.token_rows.launches == 1
    finally:
        pa.zero_counts(ba.token_rows)


@pytest.mark.parametrize("c,n,h", [(16, 3136, 12), (1, 65, 2), (9, 130, 3)])
def test_k10_tma_views_address_the_token_and_rx_rows(c, n, h):
    """The five [B, H, rows, 64] views K10's wgmma route maps: q, k and v of
    the N token rows (from row 2C) at the packed row's pitch 3D*2 bytes, k
    and v of the C RX rows (prefix rows 1, 3, ..) at twice that pitch; each
    view's base is its first row's element column h*64, D + h*64 or
    2D + h*64, and each maps with the 64-row box."""
    from msvit_tpu_torch.ops import banded_attention as ba

    b, d = 2, h * 64
    x = torch.arange(b * (2 * c + n) * 3 * d, dtype=torch.float32).reshape(b, 2 * c + n, 3 * d)
    q, k, v, rk, rv = ba.tma_views(x, h, c)
    row = 3 * d * 2  # the packed row's pitch in bf16 bytes
    for t, first, col, rows in ((q, 2 * c, 0, n), (k, 2 * c, d, n), (v, 2 * c, 2 * d, n),
                                (rk, 1, d, c), (rv, 1, 2 * d, c)):
        assert t.shape == (b, h, rows, 64)
        assert t.data_ptr() - x.data_ptr() == (first * 3 * d + col) * x.element_size()
        step = 1 if rows == n else 2
        assert torch.equal(t[:, 1], x[:, first:first + step * rows:step, col + 64:col + 128])
        got = pa.tma_map_heads(t.shape, t.stride(), 2, 4096)
        assert got["dims"] == (64, rows, h, b)
        if rows > 1:
            assert got["pitches"][0] == row * step
    assert torch.equal(rk[:, :, -1], x[:, 2 * c - 1, d:2 * d].reshape(b, h, 64))


def test_k10_tma_views_refuse_a_misaligned_qkv():
    """A bf16 qkv whose base is off 16 bytes cannot be mapped: the wgmma
    route raises, naming the wrapper, where the other routes copied it."""
    from msvit_tpu_torch.ops import banded_attention as ba

    x = torch.zeros(1 + 2 * 34 * 3 * 128, dtype=torch.bfloat16)[1:].view(2, 34, 384)
    with pytest.raises(ValueError, match="token_rows: TMA"):
        pa.check_tma_heads("token_rows", *ba.tma_views(x, 2, 1))
