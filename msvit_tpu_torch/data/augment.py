"""Batched image augmentations on NHWC tensors (counterpart of
`msvit_tpu/data/augment.py`).

Each augmentation is split in two: a *draw* step that takes every random
number it needs from an explicit `torch.Generator`, and a deterministic
*apply* step on the images and those draws, so the same draws can be fed
to both packages.  `random_*` / `mixup` / `cutmix` chain the two.  Draws
are made on the generator's device and moved to the images'; Beta draws
(mixup, cutmix) are made with numpy, seeded from the generator, since
torch's Beta sampler takes no generator.  Shapes are static: boxes are
masks over the pixel grid, never crops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msvit_tpu_torch.utils.rng import draw_seed

Draws = Dict[str, torch.Tensor]


def _uniform(g: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(n, generator=g, device=g.device) * (hi - lo) + lo


def _beta(g: torch.Generator, n: int, alpha: float) -> torch.Tensor:
    rng = np.random.default_rng(draw_seed(g))
    return torch.from_numpy(rng.beta(alpha, alpha, n).astype(np.float32))


def _col(x: torch.Tensor, images: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """[B] draw -> [B, 1, ...] on the images' device."""
    return x.to(images.device).reshape(-1, *([1] * (ndim - 1)))


# ------------------------------------------------------------------ flip ----


def draw_flip(g: torch.Generator, batch: int) -> Draws:
    return {"flip": torch.rand(batch, generator=g, device=g.device) < 0.5}


def apply_flip(images: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Horizontal flip of the images whose `flip` is true."""
    return torch.where(_col(draws["flip"], images), images.flip(2), images)


def random_flip(g: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip, per image, p = 0.5.  [B, H, W, C]."""
    return apply_flip(images, draw_flip(g, images.shape[0]))


# ---------------------------------------------------- brightness/contrast ----


def draw_brightness_contrast(g: torch.Generator, batch: int,
                             brightness: float = 0.2,
                             contrast: float = 0.2) -> Draws:
    return {"brightness": 1.0 + _uniform(g, batch, -brightness, brightness),
            "contrast": 1.0 + _uniform(g, batch, -contrast, contrast)}


def apply_brightness_contrast(images: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Per-image multiplicative brightness and contrast around the
    per-image mean."""
    bf = _col(draws["brightness"], images)
    cf = _col(draws["contrast"], images)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return (images * bf - mean) * cf + mean


def random_brightness_contrast(g: torch.Generator, images: torch.Tensor,
                               brightness: float = 0.2,
                               contrast: float = 0.2) -> torch.Tensor:
    return apply_brightness_contrast(
        images, draw_brightness_contrast(g, images.shape[0], brightness, contrast))


# ----------------------------------------------------------------- erase ----


def draw_erasing(g: torch.Generator, batch: int,
                 scale: Tuple[float, float] = (0.02, 0.2),
                 p: float = 0.5) -> Draws:
    return {"area": _uniform(g, batch, scale[0], scale[1]),
            "y": _uniform(g, batch), "x": _uniform(g, batch),
            "apply": torch.rand(batch, generator=g, device=g.device) < p}


def _box_mask(h: int, w: int, y0, y1, x0, x1) -> torch.Tensor:
    """[B, H, W] true inside [y0, y1) x [x0, x1) (per-image int bounds)."""
    yy = torch.arange(h, device=y0.device)[None, :, None]
    xx = torch.arange(w, device=y0.device)[None, None, :]
    return ((yy >= y0[:, None, None]) & (yy < y1[:, None, None])
            & (xx >= x0[:, None, None]) & (xx < x1[:, None, None]))


def apply_erasing(images: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Zero a square box per image where `apply`: side sqrt(area) of the
    image's height and width, corner at (y, x) fractions of the room."""
    _, h, w, _ = images.shape
    dev = images.device
    side = torch.sqrt(draws["area"].to(dev))
    bh = (side * h).to(torch.int32)
    bw = (side * w).to(torch.int32)
    y0 = (draws["y"].to(dev) * (h - bh)).to(torch.int32)
    x0 = (draws["x"].to(dev) * (w - bw)).to(torch.int32)
    inside = _box_mask(h, w, y0, y0 + bh, x0, x0 + bw)
    erase = inside & draws["apply"].to(dev)[:, None, None]
    return torch.where(erase[..., None], torch.zeros((), dtype=images.dtype, device=dev),
                       images)


def random_erasing(g: torch.Generator, images: torch.Tensor,
                   scale: Tuple[float, float] = (0.02, 0.2),
                   p: float = 0.5) -> torch.Tensor:
    """Zero a random square per image with probability `p`."""
    return apply_erasing(images, draw_erasing(g, images.shape[0], scale, p))


# ----------------------------------------------------------- mixup/cutmix ----


def _one_hot(labels: torch.Tensor, num_classes: Optional[int]) -> torch.Tensor:
    if labels.ndim == 1:
        if num_classes is None:
            raise ValueError("num_classes required for integer labels")
        return F.one_hot(labels.long(), num_classes).float()
    return labels.float()


def draw_mixup(g: torch.Generator, batch: int, alpha: float = 0.2) -> Draws:
    return {"lam": _beta(g, batch, alpha)}


def apply_mixup(images: torch.Tensor, labels: torch.Tensor, draws: Draws,
                num_classes: Optional[int] = None):
    """Convex-combine each image with its rolled partner (image i - 1) at
    max(lam, 1 - lam); returns (mixed images, soft targets)."""
    y = _one_hot(labels, num_classes).to(images.device)
    lam = draws["lam"].to(images.device)
    lam = torch.maximum(lam, 1.0 - lam)  # keep the original dominant
    li = _col(lam, images)
    mixed = li * images + (1.0 - li) * images.roll(1, 0)
    targets = lam[:, None] * y + (1.0 - lam[:, None]) * y.roll(1, 0)
    return mixed, targets


def mixup(g: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
          num_classes: Optional[int] = None, alpha: float = 0.2):
    """Mixup (Zhang et al. 2018), lam ~ Beta(alpha, alpha) per image."""
    return apply_mixup(images, labels, draw_mixup(g, images.shape[0], alpha),
                       num_classes)


def draw_cutmix(g: torch.Generator, batch: int, alpha: float = 1.0) -> Draws:
    lam = _beta(g, batch, alpha)
    return {"lam": lam, "y": _uniform(g, batch), "x": _uniform(g, batch)}


def apply_cutmix(images: torch.Tensor, labels: torch.Tensor, draws: Draws,
                 num_classes: Optional[int] = None):
    """Paste a box of area ~ 1 - lam from the rolled partner, centred at
    (y, x) fractions of the image and clipped to it; targets mix by the
    realized box area.  Returns (mixed images, soft targets)."""
    _, h, w, _ = images.shape
    dev = images.device
    y = _one_hot(labels, num_classes).to(dev)
    cut = torch.sqrt(1.0 - draws["lam"].to(dev))
    bh = (cut * h).to(torch.int32)
    bw = (cut * w).to(torch.int32)
    cy = (draws["y"].to(dev) * h).to(torch.int32)
    cx = (draws["x"].to(dev) * w).to(torch.int32)
    inside = _box_mask(h, w, (cy - bh // 2).clamp(0, h), (cy + bh // 2).clamp(0, h),
                       (cx - bw // 2).clamp(0, w), (cx + bw // 2).clamp(0, w))
    mixed = torch.where(inside[..., None], images.roll(1, 0), images)
    area = inside.sum(dim=(1, 2)).float() / (h * w)
    targets = (1.0 - area[:, None]) * y + area[:, None] * y.roll(1, 0)
    return mixed, targets


def cutmix(g: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
           num_classes: Optional[int] = None, alpha: float = 1.0):
    """CutMix (Yun et al. 2019)."""
    return apply_cutmix(images, labels, draw_cutmix(g, images.shape[0], alpha),
                        num_classes)
