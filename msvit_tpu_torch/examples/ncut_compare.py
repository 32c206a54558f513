"""NCut rbf against cosine (counterpart of `examples/ncut_compare.py`, the
reference's `sandbox/ncut_euclidean.py:12-30` workflow): embed the same
features under both affinities and compare their spectra and how well the
embeddings separate three blobs.

    python -m msvit_tpu_torch.examples.ncut_compare
    python -m msvit_tpu_torch.examples.ncut_compare --device cpu

The JAX example's data (three 16-d blobs of 100 points, numpy seed 1212),
6 eigenvectors from 256 anchors.  The port draws the anchors from its own
`Rng(0)` (the JAX example from `PRNGKey(0)`): `compare` takes the stream,
so a test can hand it JAX's draws.  It runs on the CUDA card; ``--device
cpu`` is the only way to the CPU (with no card and no ``--device cpu`` it
raises).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.ops.ncut import ncut
from msvit_tpu_torch.utils.rng import Rng


def blobs() -> np.ndarray:
    """Three separated 16-d blobs of 100 points each (f32)."""
    rng = np.random.default_rng(1212)
    return np.concatenate(
        [rng.standard_normal((100, 16)) + 6 * i for i in range(3)]).astype(np.float32)


def compare(x: torch.Tensor, key) -> dict:
    """Both affinities' (eigvecs, eigvals) and each embedding's mean
    within-blob spread and largest gap between blob centers."""
    out = {}
    for name in ("rbf", "cosine"):
        vecs, vals = ncut(x, num_eig=6, key=key, num_sample=256, distance=name)
        v = vecs.cpu().numpy()
        within = np.mean([np.std(v[i * 100:(i + 1) * 100], axis=0).mean() for i in range(3)])
        centers = np.stack([v[i * 100:(i + 1) * 100].mean(axis=0) for i in range(3)])
        cross = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1).max()
        out[name] = {"eigvecs": vecs, "eigvals": vals, "within": float(within),
                     "gap": float(cross)}
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = compare(torch.from_numpy(blobs()).to(dev), Rng(0))
    for name, r in res.items():
        print(f"{name:6s} eigenvalues: {np.round(r['eigvals'].cpu().numpy(), 4)}", flush=True)
    for name, r in res.items():
        print(f"{name}: within-blob spread {r['within']:.4f}, max center gap {r['gap']:.4f}",
              flush=True)
    return res


if __name__ == "__main__":
    main()
