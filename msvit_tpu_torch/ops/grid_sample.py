"""Image sampling at arbitrary points (counterpart of
`msvit_tpu/ops/grid_sample.py`), NHWC in and out.

The semantics are torch's `grid_sample` with ``align_corners=False``, which
the JAX package copies: a normalized coordinate u in [-1, 1] maps to the
pixel index ((u + 1) * size - 1) / 2; a grid's last axis is (x, y);
bicubic is cubic convolution with a = -0.75; "border" padding clamps tap
indices to the edge, "zeros" drops taps outside the image.

* `grid_sample`: arbitrary points, `F.grid_sample` around a permute to and
  from NCHW (the JAX package computes the same taps outside any kernel).
* `grid_sample_separable`: axis-aligned lattices (every glimpse here is
  one: translation and diagonal scaling) as two dense interpolation
  products per glimpse, ``Wy . image . Wx^T``, the weight matrices built as
  the JAX package builds them (`_axis_weight_matrix`).

Both are differentiable in the image and in the sample points: the
predictive losses backpropagate into the positions they sample at.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

_CUBIC_A = -0.75


def _cubic_weights(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Cubic-convolution weights of the taps at offsets (-1, 0, 1, 2) for a
    fractional position t in [0, 1)."""
    a = _CUBIC_A

    def near(d):  # |d| <= 1
        return (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0

    def far(d):  # 1 < |d| < 2
        return a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a

    return far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)


def grid_sample(
    image: torch.Tensor,  # [B, H, W, C]
    grid: torch.Tensor,  # [B, *S, 2], (x, y) in [-1, 1]
    mode: str = "bicubic",
    padding_mode: str = "border",
) -> torch.Tensor:
    """Sample `image` at normalized points `grid`; returns [B, *S, C] in
    the image's dtype.  mode: bicubic, bilinear or nearest; padding_mode:
    border or zeros."""
    if image.ndim != 4:
        raise ValueError(f"image must be [B,H,W,C], got {tuple(image.shape)}")
    if mode not in ("bicubic", "bilinear", "nearest"):
        raise ValueError(mode)
    if padding_mode not in ("border", "zeros"):
        raise ValueError(padding_mode)
    b, _, _, c = image.shape
    s = grid.shape[1:-1]
    out = F.grid_sample(image.permute(0, 3, 1, 2).float(),
                        grid.reshape(b, 1, -1, 2).float(), mode=mode,
                        padding_mode=padding_mode, align_corners=False)  # [B, C, 1, N]
    return out[:, :, 0].transpose(1, 2).reshape(b, *s, c).to(image.dtype)


def _axis_weight_matrix(coords: torch.Tensor, size: int, mode: str,
                        padding_mode: str) -> torch.Tensor:
    """[..., P, size] f32: row p holds the tap weights of sample coordinate
    p (normalized, [..., P]) along an axis of `size` pixels; "border" clamps
    the tap indices (weights pile up on the edge pixel), "zeros" drops taps
    outside."""
    f = ((coords.float() + 1.0) * size - 1.0) / 2.0
    if mode == "nearest":
        taps: List[torch.Tensor] = [torch.round(f).long()]
        weights: List[torch.Tensor] = [torch.ones_like(f)]
    else:
        x0 = torch.floor(f)
        t = f - x0
        if mode == "bicubic":
            offs, weights = (-1, 0, 1, 2), list(_cubic_weights(t))
        elif mode == "bilinear":
            offs, weights = (0, 1), [1.0 - t, t]
        else:
            raise ValueError(mode)
        taps = [x0.long() + o for o in offs]
    if padding_mode not in ("border", "zeros"):
        raise ValueError(padding_mode)
    pix = torch.arange(size, device=coords.device)
    w = torch.zeros(coords.shape + (size,), device=coords.device)
    for idx, wt in zip(taps, weights):
        if padding_mode == "zeros":
            wt = torch.where((idx >= 0) & (idx < size), wt, 0.0)
        onehot = (pix == idx.clamp(0, size - 1)[..., None]).float()
        w = w + onehot * wt[..., None]
    return w


def grid_sample_separable(
    image: torch.Tensor,  # [B, H, W, C]
    ys: torch.Tensor,  # [B, *S, Py] normalized y coordinates
    xs: torch.Tensor,  # [B, *S, Px] normalized x coordinates
    mode: str = "bicubic",
    padding_mode: str = "border",
) -> torch.Tensor:
    """`grid_sample` on the lattices outer(ys, xs), one per glimpse, as
    two interpolation products in f32.  Returns [B, *S, Py, Px, C] in the
    image's dtype."""
    b, h, w, c = image.shape
    s = ys.shape[1:-1]
    py, px = ys.shape[-1], xs.shape[-1]
    wy = _axis_weight_matrix(ys, h, mode, padding_mode).reshape(b, -1, py, h)
    wx = _axis_weight_matrix(xs, w, mode, padding_mode).reshape(b, -1, px, w)
    rows = torch.einsum("bnyh,bhwc->bnywc", wy, image.float())
    out = torch.einsum("bnxw,bnywc->bnyxc", wx, rows)
    return out.reshape(b, *s, py, px, c).to(image.dtype)
