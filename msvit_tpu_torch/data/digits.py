"""Offline real-data fixture (counterpart of `msvit_tpu/data/digits.py`;
the same arrays, split and epochs): the UCI optical-digits set bundled
inside scikit-learn (1,797 8x8 grayscale images, 10 classes).

It needs no network: the HF datasets of `data/registry.py` (the
reference's table, `infrastructure/dataset.py:3-63`) and the reference's
pretrained `facebook/dino-vitb8` weights (`sandbox/test.py:42-57`) do.  A
real labeled image set that ships inside the scikit-learn wheel, turned
into ViT-ready NHWC batches, lets a full train → eval → quantize workflow
(`msvit_tpu_torch/examples/train_digits.py`) run on learned weights, and
the int8 path be scored on a *trained* activation distribution instead of
random init.

Images are upscaled on the host once (tiny set, 8→32 nearest-neighbour
by pixel replication — no resampling artifacts on 4-bit data) and live in
one [N, S, S, 3] float32 numpy array; batches are static-shaped slices of
a per-epoch permutation.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def load_digits_arrays(
    image_size: int = 32,
    test_fraction: float = 0.2,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """→ {"train_images" [N,S,S,3] f32 in [-1,1], "train_labels" [N] i32,
    "test_images", "test_labels"}.

    Deterministic stratified split (each class split separately with the
    same fraction, `seed`-keyed permutations).  `image_size` must be a
    multiple of 8: each source pixel is replicated into a
    (S/8)×(S/8) block.  Grayscale is broadcast to 3 channels; intensity
    0..16 maps to [-1, 1].
    """
    from sklearn.datasets import load_digits  # bundled, no network

    if image_size % 8 != 0:
        raise ValueError(f"image_size must be a multiple of 8, got {image_size}")
    d = load_digits()
    images = d.images.astype(np.float32) / 8.0 - 1.0  # [N, 8, 8], [-1, 1]
    labels = d.target.astype(np.int32)

    k = image_size // 8
    images = np.repeat(np.repeat(images, k, axis=1), k, axis=2)
    images = np.broadcast_to(images[..., None], images.shape + (3,)).copy()

    rng = np.random.default_rng(seed)
    train_idx, test_idx = [], []
    for c in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == c)[0])
        n_test = max(1, int(round(len(idx) * test_fraction)))
        test_idx.append(idx[:n_test])
        train_idx.append(idx[n_test:])
    train_idx = rng.permutation(np.concatenate(train_idx))
    test_idx = np.sort(np.concatenate(test_idx))

    return {
        "train_images": images[train_idx],
        "train_labels": labels[train_idx],
        "test_images": images[test_idx],
        "test_labels": labels[test_idx],
    }


def iter_epochs(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    seed: int = 0,
    max_steps: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled-epoch batch stream of (images [B,...], labels [B]) —
    static batch shape (the ragged epoch tail is dropped), fresh
    deterministic permutation per epoch, endless unless `max_steps` is
    given.  Feeds `Trainer.fit` directly.

    Backed by `data.resumable.IndexSampler` (one shuffle implementation
    in the repo); for checkpointable mid-epoch resume, hand Trainer a
    `ResumableLoader(IndexSampler(len(images), batch_size, seed=seed),
    fetch_fn)` instead of this plain generator."""
    from msvit_tpu_torch.data.resumable import IndexSampler

    sampler = IndexSampler(len(images), batch_size, seed=seed)
    for step, idx in enumerate(sampler):
        if max_steps is not None and step >= max_steps:
            return
        yield images[idx], labels[idx]


def eval_batches(
    images: np.ndarray, labels: np.ndarray, batch_size: int
) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential eval batches for `msvit_tpu_torch.eval.evaluate` (which pads
    and masks the short tail itself)."""
    for i in range(0, len(images), batch_size):
        yield {
            "pixel_values": images[i : i + batch_size],
            "labels": labels[i : i + batch_size],
        }
