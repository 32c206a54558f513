"""Cluster-banded multistate attention (counterpart of
`msvit_tpu/ops/banded_attention.py`).

With the patch tokens sorted by cluster id, the multistate mask's
token <-> token block becomes a contiguous band of each row, and every token
has one key off the band, its cluster's RX token (prefix row 2 * cid + 1).
The op takes the fused QKV output ``[B, 2C + N, 3D]`` (rows: the 2C TX/RX
prefix, then the sorted tokens; the q third pre-scaled) and never builds an
``[S, S]`` mask:

* `token_rows` -- K10, the TPU kernel `_token_rows_banded`: the N token
  rows, walking only the key tiles of each row block's band (the band
  table `band_limits`, torch `searchsorted`), the shaved softmax
  exp(clip(s, +-80)) with no row max, o / max(l, 1e-30).  Kernel:
  `csrc/banded_attention.cu` (bf16 on the tensor cores, skipping the
  16-key blocks of other clusters; f32 on the CUDA cores).  Under
  autograd it is `TokenRowsFunction`, whose backward differentiates the
  plain version, as the JAX VJP differentiates `_token_rows_xla`.
* `prefix_rows` -- the 2C TX/RX rows, dense over every key with the exact
  soft additive mask (plain torch, as the JAX package leaves them to XLA),
  and optionally the RX -> TX probabilities.
* `multistate_banded_attention` -- both, concatenated.

Rounding: the TPU kernel rounds p to the compute dtype and sums that
rounded p into both l and P.V; `_token_rows_xla` (the JAX VJP's oracle)
sums the unrounded p into l.  `token_rows_plain` follows the TPU kernel.

Against the dense soft-masked path, a masked token-row key weighs 0 here
instead of e^{-100} (at most e^{-80} after the clip).

The wrapper takes the plain version for a tensor on the CPU, and for a
tensor on the card launches the kernel or raises: there is no fallback.  It
counts its launches (`token_rows.launches`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from msvit_tpu_torch.ops import _build
from msvit_tpu_torch.ops.packed_attention import _DTYPE_CODES, _acc, _dims

_CLIP = 80.0
BAND_ROWS = 64  # query rows per block of the band table (the kernel's block)
BAND_KEYS = 64  # keys per tile of the band table


class BandedSegments(NamedTuple):
    """Cluster structure handed to the attention layer in banded mode.
    ``cid`` is sorted ascending along the token axis (the backbone keeps
    tokens cluster-sorted between re-clusterings)."""

    cid: torch.Tensor  # [B, N] int, sorted ascending per image
    n_clusters: torch.Tensor  # [] or [B] int: valid TX/RX slots
    max_clusters: int
    mask_inf: float  # the soft-mask penalty


def band_limits(cid: torch.Tensor, max_clusters: int, rows: int = BAND_ROWS,
                keys: int = BAND_KEYS) -> torch.Tensor:
    """[B, 2, ceil(N / rows)] int32: the inclusive range [kmin, kmax] of
    `keys`-key tiles that holds the live keys of each `rows`-row query block:
    the tokens of clusters cid[first row] .. cid[last row], contiguous in
    the sorted layout (JAX's `_band_limits` at its own block sizes, with
    one searchsorted per block edge where JAX takes one per cluster id, so
    `max_clusters` is not needed: fewer launches per call)."""
    n = cid.shape[1]
    cid = cid.contiguous()
    first = torch.arange(0, n, rows, device=cid.device)  # each block's first row
    # the first token of the first row's cluster, one past the last row's
    start = torch.searchsorted(cid, cid[:, first])
    end = torch.searchsorted(cid, cid[:, (first + rows - 1).clamp_max(n - 1)], right=True)
    kmin = start // keys
    return torch.stack([kmin, torch.maximum((end - 1) // keys, kmin)], 1).to(torch.int32)


def token_rows_plain(qkv: torch.Tensor, cid: torch.Tensor, num_heads: int,
                     max_clusters: int) -> torch.Tensor:
    """Plain version of K10: a token row attends the tokens of its cluster
    and its RX (prefix column 2 * cid + 1); p = exp(clip(s, +-80)) where
    attended, 0 elsewhere, rounded to qkv's dtype; l and P.V sum that
    rounded p (the TPU kernel's order); o / max(l, 1e-30).  Returns
    [B, N, D] in qkv's dtype; f64 inputs compute in f64."""
    acc = _acc(qkv.dtype)
    b, s, _, dh = _dims(qkv, num_heads)
    pfx = 2 * max_clusters
    n = s - pfx
    x = qkv.reshape(b, s, 3, num_heads, dh)
    q = x[:, pfx:, 0].transpose(1, 2)  # [B, H, N, dh]
    k = x[:, :, 1].transpose(1, 2)  # [B, H, S, dh]
    v = x[:, :, 2].transpose(1, 2)
    cols = torch.arange(s, device=qkv.device)
    own_rx = cols[None, None, :] == (2 * cid[:, :, None] + 1)  # [B, N, S]
    key_cid = F.pad(cid, (pfx, 0), value=-1)
    intra = (cols[None, None, :] >= pfx) & (cid[:, :, None] == key_cid[:, None, :])
    m = (own_rx | intra)[:, None]  # [B, 1, N, S]
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    p = torch.where(m, torch.exp(scores.clamp(-_CLIP, _CLIP)), 0.0)
    p = p.to(qkv.dtype).to(acc)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v.to(acc)) / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(b, n, -1).to(qkv.dtype)


def _token_rows_forward(qkv, cid, num_heads, max_clusters):
    """K10 for a CUDA tensor (counted on `token_rows.launches`), the plain
    version for a CPU one."""
    b, s, d, dh = _dims(qkv, num_heads)
    pfx = 2 * max_clusters
    n = s - pfx
    if tuple(cid.shape) != (b, n):
        raise ValueError(f"cid {tuple(cid.shape)} must be {(b, n)}")
    if qkv.device.type == "cpu":
        return token_rows_plain(qkv, cid, num_heads, max_clusters)
    name = "token_rows"
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {qkv.dtype} unsupported (f32 or bf16)")
    if dh % 8 or dh > 128:
        raise ValueError(f"{name}: head size {dh} unsupported (a multiple of 8, <= 128)")
    if cid.device != qkv.device:
        raise ValueError(f"{name}: cid on another device")
    es = qkv.element_size()
    if not (qkv.stride(2) == 1 and qkv.data_ptr() % 16 == 0
            and (qkv.stride(0) * es) % 16 == 0 and (qkv.stride(1) * es) % 16 == 0):
        qkv = qkv.contiguous()
    cid32 = cid.to(torch.int32).contiguous()
    band = band_limits(cid32, max_clusters)
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.msvit_banded_attention(
            qkv.data_ptr(), cid32.data_ptr(), band.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[qkv.dtype], b, n, pfx, num_heads, dh, qkv.stride(0),
            qkv.stride(1), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, name)
    token_rows.launches += 1
    return out


def token_rows(qkv: torch.Tensor, cid: torch.Tensor, num_heads: int,
               max_clusters: int) -> torch.Tensor:
    """The token rows' attention output [B, N, D] (K10).  qkv [B, 2C + N,
    3D] bf16 or f32, the q third pre-scaled, rows [prefix ++ sorted
    tokens]; cid [B, N] sorted ascending per image, values in [0, C).

    Under autograd (grad enabled and qkv requiring grad) this is
    `TokenRowsFunction`; otherwise K10 (the plain version on the CPU)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return TokenRowsFunction.apply(qkv, cid, num_heads, max_clusters)
    return _token_rows_forward(qkv, cid, num_heads, max_clusters)


token_rows.launches = 0


class TokenRowsFunction(torch.autograd.Function):
    """The JAX `_token_rows` custom VJP: the forward is K10 (saving qkv and
    cid), the backward differentiates the plain version.  Nothing flows to
    cid."""

    @staticmethod
    def forward(ctx, qkv, cid, num_heads, max_clusters):
        ctx.save_for_backward(qkv, cid)
        ctx.args = (num_heads, max_clusters)
        return _token_rows_forward(qkv, cid, num_heads, max_clusters)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, cid = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            out = token_rows_plain(x, cid, *ctx.args)
            (dqkv,) = torch.autograd.grad(out, x, g)
        return dqkv, None, None, None


def prefix_rows(qkv: torch.Tensor, cid: torch.Tensor, n_clusters,
                max_clusters: int, num_heads: int, mask_inf: float,
                output_rx_tx: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The 2C TX/RX rows, dense over all keys with the exact soft additive
    mask (scores - mask_inf * (1 - mask), the shaved softmax): TX_c attends
    the tokens of cluster c, a valid RX every valid TX; an invalid slot's
    row is fully penalised (uniform attention, as on the dense path).
    Returns (out [B, 2C, D] in qkv's dtype, RX -> TX probabilities
    [B, H, C, C] f32 or None)."""
    acc = _acc(qkv.dtype)
    b, s = qkv.shape[:2]
    c = max_clusters
    pfx = 2 * c
    x = qkv.reshape(b, s, 3, num_heads, -1)
    q = x[:, :pfx, 0].transpose(1, 2)  # [B, H, 2C, dh]
    k = x[:, :, 1].transpose(1, 2)
    v = x[:, :, 2].transpose(1, 2)
    dev = qkv.device
    nc = torch.as_tensor(n_clusters, device=dev).broadcast_to((b,))
    cvalid = torch.arange(c, device=dev)[None] < nc[:, None]  # [B, C]
    rows = torch.arange(pfx, device=dev)
    cols = torch.arange(s, device=dev)
    is_tx = (rows % 2 == 0)[None, :, None]
    key_cid = F.pad(cid, (pfx, 0), value=-1)
    tok_of_c = (cols[None, None, :] >= pfx) & (key_cid[:, None, :] == (rows // 2)[None, :, None])
    col_is_tx = (cols < pfx) & (cols % 2 == 0)
    col_valid = cvalid[:, (cols // 2).clamp(0, c - 1)]  # [B, S]
    row_valid = cvalid[:, rows // 2]  # [B, 2C]
    rx_tx = row_valid[:, :, None] & (col_is_tx[None, :] & col_valid)[:, None, :]
    m = torch.where(is_tx, tok_of_c, rx_tx)[:, None]  # [B, 1, 2C, S]
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    scores = scores - mask_inf * (1.0 - m.to(acc))
    p = torch.exp(scores.clamp(-_CLIP, _CLIP))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / l
    out = o.transpose(1, 2).reshape(b, pfx, -1).to(qkv.dtype)
    rx_to_tx = None
    if output_rx_tx:
        rx_to_tx = (p / l)[:, :, 1::2, 0:pfx:2].float()
    return out, rx_to_tx


def multistate_banded_attention(
    qkv: torch.Tensor,  # [B, 2C + N, 3D], q pre-scaled
    segments: BandedSegments,
    num_heads: int,
    output_rx_tx: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The multistate attention output [B, 2C + N, D] of a cluster-sorted
    sequence; with `output_rx_tx` also the RX -> TX probabilities
    [B, H, C, C] (exact: the prefix rows are dense)."""
    seg = segments
    pfx_out, rx_to_tx = prefix_rows(qkv, seg.cid, seg.n_clusters, seg.max_clusters,
                                    num_heads, seg.mask_inf, output_rx_tx)
    out = torch.cat([pfx_out, token_rows(qkv, seg.cid, num_heads, seg.max_clusters)], 1)
    return (out, rx_to_tx) if output_rx_tx else out
