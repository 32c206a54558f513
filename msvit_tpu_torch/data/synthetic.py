"""Procedural image corpus (counterpart of `msvit_tpu/data/synthetic.py`,
the port's own copy: pixels, labels and regions are bit-equal to the JAX
package's for the same seeds).

Composited textured shapes whose **labels and region masks come from the
generative parameters**, so cluster-vs-region scores are exactly
computable and no dataset has to be downloaded.

Scene model
-----------
* background: one procedural texture (flat / grating / smooth noise /
  checker) over the full frame;
* 1..max_objects foreground objects, each a rotated signed-distance
  shape (circle, rectangle, triangle, ring, cross) filled with its own
  texture, composited back-to-front;
* regions[y, x] = 0 for background, i for object i (z-order id).

Label modes
-----------
``largest`` (default): the shape class of the object with the most visible
pixels (5-way).  ``center``: one target object is placed near the center
(|cx|, |cy| <= 0.15, scale in (0.10, 0.35)), drawn last so it is never
occluded, and the label is its shape class.  ``texture``: the ``center``
geometry, labeled with the target's texture kind (4-way), decodable from
any interior patch.  ``ltexture``: the ``largest`` geometry (the same
random stream and images), labeled with the texture kind of the largest
visible object.

Everything is deterministic in the seed, pure numpy, vectorized over the
pixel grid.  `write_corpus` JPEG-encodes the images to disk (PIL), so that
loading goes through the decode path of `data.pipeline`; a caller without
PIL hands `generate_batch`'s dict to the trainers directly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

SHAPE_CLASSES: Tuple[str, ...] = (
    "circle",
    "rectangle",
    "triangle",
    "ring",
    "cross",
)
TEXTURES: Tuple[str, ...] = ("flat", "grating", "noise", "checker")


def label_classes(label_mode: str) -> Tuple[str, ...]:
    """The class vocabulary of a label mode (labels index into this)."""
    return (
        TEXTURES
        if label_mode in ("texture", "ltexture")
        else SHAPE_CLASSES
    )


# ---------------------------------------------------------------------------
# textures


def _smooth_noise(rng: np.random.Generator, size: int, cells: int) -> np.ndarray:
    """[size, size] in [0,1]: bilinear upsampling of a coarse normal grid."""
    coarse = rng.standard_normal((cells + 1, cells + 1))
    t = np.linspace(0.0, cells, size)
    i0 = np.minimum(t.astype(np.int64), cells - 1)
    f = t - i0
    # separable bilinear: rows then columns
    rows = coarse[i0] * (1.0 - f)[:, None] + coarse[i0 + 1] * f[:, None]
    out = rows[:, i0] * (1.0 - f)[None, :] + rows[:, i0 + 1] * f[None, :]
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo + 1e-9)


def _texture(
    rng: np.random.Generator, size: int, kind: str
) -> np.ndarray:
    """[size, size, 3] float in [0,1]."""
    c0 = rng.uniform(0.05, 0.95, size=3)
    c1 = rng.uniform(0.05, 0.95, size=3)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    if kind == "flat":
        w = np.full((size, size), 0.0)
    elif kind == "grating":
        freq = rng.uniform(2.0, 12.0)
        theta = rng.uniform(0.0, np.pi)
        phase = rng.uniform(0.0, 2 * np.pi)
        w = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta))
            + phase
        )
    elif kind == "noise":
        w = _smooth_noise(rng, size, int(rng.integers(3, 9)))
    elif kind == "checker":
        n = int(rng.integers(3, 9))
        w = (
            (np.floor((xx + 1) * n / 2) + np.floor((yy + 1) * n / 2)) % 2
        ).astype(np.float64)
    else:  # pragma: no cover - guarded by TEXTURES
        raise ValueError(f"unknown texture {kind!r}")
    return c0[None, None, :] * (1.0 - w[..., None]) + c1[None, None, :] * w[
        ..., None
    ]


# ---------------------------------------------------------------------------
# shapes (signed-distance style occupancy over the rotated local frame)


def _shape_mask(
    shape: str,
    size: int,
    cx: float,
    cy: float,
    scale: float,
    angle: float,
    aspect: float,
) -> np.ndarray:
    """[size, size] bool occupancy.  Coordinates in [-1,1]^2; `scale` is
    the object half-extent, `aspect` the x/y stretch, `angle` rotation."""
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    x = xx - cx
    y = yy - cy
    ca, sa = np.cos(angle), np.sin(angle)
    u = (x * ca + y * sa) / (scale * aspect)
    v = (-x * sa + y * ca) / (scale / aspect)
    if shape == "circle":
        return u * u + v * v <= 1.0
    if shape == "rectangle":
        return (np.abs(u) <= 1.0) & (np.abs(v) <= 0.7)
    if shape == "triangle":
        # upward triangle: v in [-1, 1], half-width shrinking with v
        return (v >= -1.0) & (v <= 1.0) & (np.abs(u) <= (1.0 - v) / 2.0)
    if shape == "ring":
        r2 = u * u + v * v
        return (r2 <= 1.0) & (r2 >= 0.45**2)
    if shape == "cross":
        return ((np.abs(u) <= 0.35) & (np.abs(v) <= 1.0)) | (
            (np.abs(v) <= 0.35) & (np.abs(u) <= 1.0)
        )
    raise ValueError(f"unknown shape {shape!r}")


# ---------------------------------------------------------------------------
# scene generation


def generate_scene(
    seed: int,
    size: int = 224,
    max_objects: int = 3,
    min_objects: int = 1,
    label_mode: str = "largest",
) -> Dict[str, np.ndarray]:
    """One scene: {'image' uint8 [S,S,3], 'regions' uint8 [S,S],
    'label' int, 'params' list} — all derived from the seeded RNG.

    ``center`` and ``texture`` draw one extra *target* object last:
    centered, unoccluded, scale in (0.10, 0.35)."""
    if label_mode not in ("largest", "center", "texture", "ltexture"):
        raise ValueError(f"unknown label_mode {label_mode!r}")
    rng = np.random.default_rng(seed)
    img = _texture(rng, size, TEXTURES[rng.integers(len(TEXTURES))])
    regions = np.zeros((size, size), np.uint8)
    if label_mode in ("center", "texture"):
        # distractors (possibly zero) + one final target
        n_obj = int(rng.integers(min_objects, max_objects + 1))
        n_distract = n_obj - 1
    else:
        n_obj = int(rng.integers(min_objects, max_objects + 1))
        n_distract = n_obj
    params = []
    classes = []

    def _draw(i: int, p: Dict) -> None:
        nonlocal img, regions
        mask = _shape_mask(
            p["shape"], size, p["cx"], p["cy"], p["scale"], p["angle"],
            p["aspect"],
        )
        tex = _texture(rng, size, p["texture"])
        img = np.where(mask[..., None], tex, img)
        regions = np.where(mask, np.uint8(i), regions)
        params.append(p)
        classes.append(SHAPE_CLASSES.index(p["shape"]))

    for i in range(1, n_distract + 1):
        _draw(i, dict(
            shape=SHAPE_CLASSES[int(rng.integers(len(SHAPE_CLASSES)))],
            cx=float(rng.uniform(-0.55, 0.55)),
            cy=float(rng.uniform(-0.55, 0.55)),
            scale=float(rng.uniform(0.18, 0.42)),
            angle=float(rng.uniform(0.0, np.pi)),
            aspect=float(rng.uniform(0.8, 1.25)),
            texture=TEXTURES[int(rng.integers(len(TEXTURES)))],
        ))
    if label_mode in ("center", "texture"):
        # target: centered, on top of the z-order, small-to-mid scale
        _draw(n_distract + 1, dict(
            shape=SHAPE_CLASSES[int(rng.integers(len(SHAPE_CLASSES)))],
            cx=float(rng.uniform(-0.15, 0.15)),
            cy=float(rng.uniform(-0.15, 0.15)),
            scale=float(rng.uniform(0.10, 0.35)),
            angle=float(rng.uniform(0.0, np.pi)),
            aspect=float(rng.uniform(0.8, 1.25)),
            texture=TEXTURES[int(rng.integers(len(TEXTURES)))],
            target=True,
        ))
        label = (
            TEXTURES.index(params[-1]["texture"])
            if label_mode == "texture"
            else classes[-1]
        )
    else:
        # visible areas (later objects may occlude earlier ones)
        visible = [int((regions == i).sum()) for i in range(1, n_obj + 1)]
        big = int(np.argmax(visible))
        label = (
            TEXTURES.index(params[big]["texture"])
            if label_mode == "ltexture"
            else classes[big]
        )
    image_u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return {
        "image": image_u8,
        "regions": regions,
        "label": int(label),
        "params": params,
    }


def generate_batch(
    seeds: Sequence[int],
    size: int = 224,
    max_objects: int = 3,
    label_mode: str = "largest",
) -> Dict[str, np.ndarray]:
    """Stacked scenes: images [B,S,S,3] u8, regions [B,S,S] u8, labels [B]."""
    scenes = [
        generate_scene(int(s), size, max_objects, label_mode=label_mode)
        for s in seeds
    ]
    return {
        "images": np.stack([s["image"] for s in scenes]),
        "regions": np.stack([s["regions"] for s in scenes]),
        "labels": np.asarray([s["label"] for s in scenes], np.int32),
    }


# ---------------------------------------------------------------------------
# on-disk corpus (JPEG images + npz masks/labels)


def write_corpus(
    directory: str,
    num_images: int,
    seed: int = 0,
    size: int = 224,
    max_objects: int = 3,
    quality: int = 92,
    label_mode: str = "largest",
) -> str:
    """JPEG-encode `num_images` scenes under `directory` (images/%06d.jpg)
    plus `meta.npz` (labels, regions) and `manifest.json`.  Returns the
    manifest path.  JPEG on purpose: loading decodes through
    `data.pipeline.decode_jpeg_images_u8`, the real input path."""
    from PIL import Image

    directory = os.path.abspath(directory)
    img_dir = os.path.join(directory, "images")
    os.makedirs(img_dir, exist_ok=True)
    labels = np.zeros((num_images,), np.int32)
    regions = np.zeros((num_images, size, size), np.uint8)
    for i in range(num_images):
        scene = generate_scene(
            seed * 1_000_003 + i, size, max_objects, label_mode=label_mode
        )
        labels[i] = scene["label"]
        regions[i] = scene["regions"]
        Image.fromarray(scene["image"]).save(
            os.path.join(img_dir, f"{i:06d}.jpg"), quality=quality
        )
    np.savez_compressed(
        os.path.join(directory, "meta.npz"), labels=labels, regions=regions
    )
    manifest = {
        "num_images": num_images,
        "size": size,
        "seed": seed,
        "max_objects": max_objects,
        "num_classes": len(label_classes(label_mode)),
        "classes": list(label_classes(label_mode)),
        "quality": quality,
        "label_mode": label_mode,
    }
    path = os.path.join(directory, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def load_corpus(
    directory: str, limit: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Decode the whole corpus into RAM: images [N,S,S,3] uint8 (through
    `data.pipeline.decode_jpeg_images_u8`), labels [N] int32, regions
    [N,S,S] uint8.  Decoded once up front: per-step host decode would
    starve the device, while the decoded corpus (2048 images at 224 px are
    308 MB of uint8) streams from RAM."""
    from msvit_tpu_torch.data.pipeline import (
        ImagePipelineConfig, decode_jpeg_images_u8)

    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["num_images"] if limit is None else min(
        limit, manifest["num_images"]
    )
    blobs = []
    for i in range(n):
        with open(os.path.join(directory, "images", f"{i:06d}.jpg"), "rb") as f:
            blobs.append(f.read())
    images = decode_jpeg_images_u8(
        blobs, ImagePipelineConfig(image_size=manifest["size"])
    )
    meta = np.load(os.path.join(directory, "meta.npz"))
    return {
        "images": images,
        "labels": meta["labels"][:n].astype(np.int32),
        "regions": meta["regions"][:n],
        "num_classes": manifest["num_classes"],
    }


def ensure_corpus(
    out_dir: str,
    num_images: int,
    size: int = 224,
    seed: int = 0,
    max_objects: int = 3,
    label_mode: str = "largest",
) -> Dict[str, np.ndarray]:
    """Idempotent corpus: write `<out_dir>/corpus<size>` (suffixed
    `_<label_mode>` for non-default modes) if absent (or too small), then
    load and return it.  Shared by the learning runs, so that pretrain and
    the family runs all see the same images."""
    import time

    suffix = "" if label_mode == "largest" else f"_{label_mode}"
    if max_objects != 3:
        suffix += f"_m{max_objects}"
    d = os.path.join(out_dir, f"corpus{size}{suffix}")
    manifest = os.path.join(d, "manifest.json")
    have = 0
    if os.path.exists(manifest):
        with open(manifest) as f:
            have = json.load(f)["num_images"]
    if have < num_images:
        t0 = time.time()
        write_corpus(d, num_images, seed=seed, size=size,
                     max_objects=max_objects, label_mode=label_mode)
        print(f"wrote {num_images} JPEG scenes to {d} "
              f"in {time.time() - t0:.0f}s")
    return load_corpus(d, limit=num_images)


def corpus_batches(
    data: Dict[str, np.ndarray],
    batch_size: int,
    seed: int = 0,
    include_regions: bool = False,
    uint8: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batch stream over a loaded (or generated) corpus.
    Images come out as float32 in [-1, 1] (the families' pixel range), or
    raw uint8 with `uint8=True`: a quarter of the host-to-device traffic
    (9.6 MB against 38.5 MB a batch at bs64 / 224 px), with the
    /127.5 - 1 normalization done on the device."""
    n = len(data["labels"])
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo : lo + batch_size]
            batch = {
                "pixel_values": (
                    data["images"][idx]
                    if uint8
                    else data["images"][idx].astype(np.float32) / 127.5 - 1.0
                ),
                "labels": data["labels"][idx],
            }
            if include_regions:
                batch["regions"] = data["regions"][idx]
            yield batch
