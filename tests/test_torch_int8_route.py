"""The int8 serving attention's route and its wgmma kernel's layouts (K3
and K9, `msvit_tpu_torch/ops/packed_attention.py`), kept in Python so that
the CPU can check them: head size 64 takes the s8 wgmma kernel fed by TMA,
other head sizes the mma.sync kernel; the wgmma route's TMA map over the
packed int8 qkv (64-byte boxes, 64-byte swizzle) and its refusals; the key
order in which the kernel packs pq into P.V's A registers and writes V^T
(`csrc/attention_int8_wgmma.cuh`), mirrored byte for byte, whose product
is P.V exactly in integers; K9's mask as that route's TMA map reads it.
No JAX, no kernel: a few milliseconds."""

import numpy as np
import pytest
import torch

from msvit_tpu_torch.ops import packed_attention as pa


@pytest.mark.parametrize("dh,route", [
    (64, "wgmma"), (8, "mma.sync"), (16, "mma.sync"), (32, "mma.sync"), (40, "mma.sync"),
    (56, "mma.sync"), (72, "mma.sync"), (80, "mma.sync"), (128, "mma.sync"),
])
def test_int8_route(dh, route):
    assert pa.int8_kernel_route(dh) == route


@pytest.mark.parametrize("dh", [0, -64, 12, 60, 136, 192])
def test_int8_route_refuses(dh):
    with pytest.raises(ValueError):
        pa.int8_kernel_route(dh)


def test_int8_route_leaves_the_bf16_rule():
    """The bf16/f32 rule still refuses int8: K3 and K9 have their own."""
    with pytest.raises(TypeError):
        pa.kernel_route(torch.int8, 64)


@pytest.mark.parametrize("b,n,heads", [(64, 197, 12), (8, 816, 12), (1, 1, 1), (3, 63, 10)])
def test_tma_map_int8_geometry(b, n, heads):
    """Dims (3D, N, B) innermost first, pitches 3D and N 3D bytes, one box
    = one head's 64 bytes of 64 rows (4096 bytes), 64-byte swizzle; each
    head's q, k and v boxes start on a 64-byte column inside the row."""
    d = heads * 64
    geo = pa.tma_map_int8((b, n, 3 * d), 0x7f0000001000)
    assert geo == {"dims": (3 * d, n, b), "pitches": (3 * d, 3 * d * n), "box": (64, 64, 1),
                   "box_bytes": 4096, "swizzle": 64}
    for h in range(heads):
        for c in pa.head_columns(heads, h):
            assert c % 64 == 0 and c + geo["box"][0] <= geo["dims"][0]


@pytest.mark.parametrize("shape,ptr", [
    ((2, 197, 2304), 0x1008),  # base off 16 bytes
    ((2, 197, 2304), 0x1001),
    ((2, 197, 120), 0x1000),   # a row pitch of 120 bytes (dh 40)
    ((2, 197, 24), 0x1000),
])
def test_tma_map_int8_refuses(shape, ptr):
    with pytest.raises(ValueError, match="TMA"):
        pa.tma_map_int8(shape, ptr)


def test_int8_wgmma_route_refuses_a_misaligned_qkv():
    """A qkv_q view at a base off 16 bytes on the wgmma route raises a
    ValueError naming the wrapper; it is never copied.  The mma.sync route
    takes no TMA map."""
    flat = torch.zeros(2 * 5 * 3 * 128 + 16, dtype=torch.int8)
    off = (16 - flat.data_ptr() % 16) % 16 + 8
    qkv = flat[off:off + 2 * 5 * 384].view(2, 5, 384)
    assert qkv.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="packed_attention_int8: TMA"):
        pa._check_int8_route("packed_attention_int8", qkv, 64)
    assert pa._check_int8_route("packed_attention_int8", qkv.view(2, 5, 384), 32) == "mma.sync"


def test_int8_pv_key_order_is_a_permutation():
    order = pa.int8_pv_key_order()
    assert sorted(order) == list(range(32))
    assert order[:8] == (0, 1, 8, 9, 2, 3, 10, 11)
    assert order[16:] == tuple(16 + k for k in order[:16])


# ----------------------------------------------- the kernel's mirrors ----


def _swizzle64(r, c):
    """`hopper::swizzle64`: byte c of row r of a 64-byte-swizzled s8 tile."""
    return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15)


def _tma_tile(v):
    """A [64][64] int8 tile as TMA lands it with the 64-byte swizzle."""
    buf = np.zeros(4096, np.int8)
    for r in range(64):
        for c in range(64):
            buf[_swizzle64(r, c)] = v[r, c]
    return buf


def _transpose_v(buf):
    """`int8_transpose_v`: V^T's 4096 swizzled bytes from V's, unit by unit
    (word w of a V^T row, head columns 4cg..4cg+3)."""
    vt = np.zeros(4096, np.int8)
    for u in range(256):
        w, cg = u & 15, u >> 4
        ww = w & 7
        key = 32 * (w >> 3) + (2 * ww if ww < 4 else 8 + 2 * ww)
        rows = (key, key + 1, key + 8, key + 9)
        words = [buf[_swizzle64(r, 4 * cg):_swizzle64(r, 4 * cg) + 4] for r in rows]
        for i in range(4):  # head column 4cg + i: byte i of each of the four rows
            at = _swizzle64(4 * cg + i, 4 * w)
            vt[at:at + 4] = [words[k][i] for k in range(4)]
    return vt


def _a_operand(p):
    """`int8_acc_to_a` for every lane of a warp's 16 rows: P's s8 A operand
    of both 32-key k-steps of a 64-key tile, as the logical [16][64] matrix
    the product reads (position 32kk + 4t + i of a0/a1, 32kk + 16 + 4t + i
    of a2/a3).  Lane (g, t) holds the accumulator value idx = 4j + e at row
    g + 8 (e >> 1), key 8j + 2t + (e & 1)."""
    a = np.zeros((16, 64), np.int64)
    for g in range(8):
        for t in range(4):
            def acc(idx):
                j, e = idx // 4, idx % 4
                return p[g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]
            for kk in range(2):
                base = 16 * kk
                regs = [(base + 0, base + 1, base + 4, base + 5),    # a0: row g
                        (base + 2, base + 3, base + 6, base + 7),    # a1: row g + 8
                        (base + 8, base + 9, base + 12, base + 13),  # a2: row g
                        (base + 10, base + 11, base + 14, base + 15)]  # a3: row g + 8
                for reg, idxs in enumerate(regs):
                    row = g + 8 * (reg & 1)
                    col = 32 * kk + 16 * (reg >> 1) + 4 * t
                    a[row, col:col + 4] = [acc(i) for i in idxs]
    return a


def _vt_logical(vt):
    """V^T's swizzled bytes as the logical [64 columns][64 keys] matrix the
    product's B operand reads (K-major)."""
    return np.array([[vt[_swizzle64(n, k)] for k in range(64)] for n in range(64)], np.int64)


@pytest.mark.parametrize("valid", [64, 37, 1])
def test_int8_pv_permuted_product_is_exact(valid):
    """P permuted (the A registers) . V^T permuted (the transposer's bytes)
    equals P.V in integers, over one 64-key tile (two 32-key k-steps) and
    over a ragged last tile whose keys past `valid` carry pq = 0 and V's
    zero-filled rows."""
    rng = np.random.default_rng(valid)
    p = rng.integers(0, 128, (16, 64))
    v = rng.integers(-127, 128, (64, 64)).astype(np.int8)
    p[:, valid:] = 0
    v[valid:] = 0
    a = _a_operand(p)
    b = _vt_logical(_transpose_v(_tma_tile(v)))
    order = np.array(pa.int8_pv_key_order())
    for kk in range(2):  # the layouts are the key order, k-step by k-step
        np.testing.assert_array_equal(a[:, 32 * kk:32 * kk + 32], p[:, 32 * kk + order])
        np.testing.assert_array_equal(b[:, 32 * kk:32 * kk + 32],
                                      v.astype(np.int64).T[:, 32 * kk + order])
    got = sum(a[:, 32 * kk:32 * kk + 32] @ b[:, 32 * kk:32 * kk + 32].T for kk in range(2))
    np.testing.assert_array_equal(got, p @ v.astype(np.int64))


def test_swizzle64_is_a_bijection_of_each_atom():
    """Each 512-byte atom (8 rows of 64 bytes) maps onto itself, 16-byte
    chunks whole."""
    offs = {_swizzle64(r, c) for r in range(64) for c in range(64)}
    assert offs == set(range(4096))
    for r in range(64):
        for c in range(0, 64, 16):
            at = _swizzle64(r, c)
            assert at // 512 == r // 8 and at % 16 == 0
            assert [_swizzle64(r, c + i) - at for i in range(16)] == list(range(16))


@pytest.mark.parametrize("dtype,n,padded", [
    (torch.bfloat16, 816, 816), (torch.bfloat16, 13, 16), (torch.bfloat16, 129, 136),
    (torch.uint8, 816, 816), (torch.uint8, 813, 816), (torch.uint8, 64, 64),
])
def test_int8_mask_operand_rows_on_16_bytes(dtype, n, padded):
    """K9's mask as the wgmma route's TMA map reads it: rows a multiple of
    16 bytes, the entries unchanged, the padding zero; a mask already so is
    handed over as it is."""
    g = torch.Generator().manual_seed(n)
    m = (torch.randn(2, 3, n, n, generator=g) * 100).to(dtype)
    got = pa.int8_mask_operand(m)
    assert got.shape == (2, 3, n, padded)
    assert got.stride(2) * got.element_size() % 16 == 0
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :n], m)
    assert not got[..., n:].any()
    if padded == n:
        assert got is m
