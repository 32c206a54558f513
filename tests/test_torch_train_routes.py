"""The route rule of K1-lse and K2 and the geometry of the wgmma route's TMA
maps (`msvit_tpu_torch/ops/packed_attention.py`), kept in Python so that
the CPU can check them: bf16 at head size 64 takes the wgmma kernels,
other bf16 head sizes the mma.sync kernels, f32 the CUDA cores; the maps
are 3-D over the packed [B, N, W] tensors with a (64, 64, 1) box at each
head's q, k and v columns.  No JAX, no kernel: a few milliseconds."""

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
    assert pa.train_route(dtype, dh) == route


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError),
    (torch.int8, 64, TypeError),
    (torch.bfloat16, 12, ValueError),
    (torch.bfloat16, 136, ValueError),
    (torch.bfloat16, 0, ValueError),
])
def test_train_route_refuses(dtype, dh, error):
    with pytest.raises(error):
        pa.train_route(dtype, dh)


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
    `reset_train_counts` zeroes every route's count."""
    pa.packed_attention_lse.wgmma_launches = 3
    pa.reset_train_counts()
    x = torch.randn(1, 7, 3 * 2 * 64)
    out, lse = pa.packed_attention_lse(x, 2)
    pa.packed_attention_bwd(x, None, out, lse, torch.randn(1, 7, 128), 2)
    zero = {r: 0 for r in pa.ROUTES}
    assert pa.train_route_counts() == {"K1-lse": zero, "K2": zero}
    assert pa.packed_attention_lse.launches == pa.packed_attention_bwd.launches == 0
