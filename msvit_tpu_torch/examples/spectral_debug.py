"""Spectral-clustering debug inspection (counterpart of
`examples/spectral_debug.py`), end to end on synthetic patch-token
features: NCut-embed the tokens, label them by HDBSCAN, seeded KMeans and
the axis-aligned `kway_ncut`, and draw the label rows and the t-SNE panels
(`viz.visualize_spectral_debug`; matplotlib needed, on the Agg backend).

    python -m msvit_tpu_torch.examples.spectral_debug [outdir]
    python -m msvit_tpu_torch.examples.spectral_debug /tmp/sd --device cpu

The same argument as the JAX example (the output directory, default
/tmp/msvit_spectral_debug), plus ``--device``: the NCut, HDBSCAN's
distances and the t-SNE run on the CUDA card; ``--device cpu`` is the only
way to the CPU (with no card and no ``--device cpu`` it raises).  The
tokens: 3 images of a 28 x 28 patch grid whose left and right halves come
from two feature clusters (numpy seed 0); the NCut draws from `Rng(0)`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.ops.ncut import ncut
from msvit_tpu_torch.utils.rng import Rng


def main(argv: Optional[List[str]] = None, tsne_iters: int = 500) -> dict:
    """Run the inspection; returns the labellings.  `tsne_iters` (the
    tests pass a few) is the t-SNE's iteration count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="/tmp/msvit_spectral_debug")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    import matplotlib

    matplotlib.use("Agg")
    from msvit_tpu_torch.viz import visualize_spectral_debug

    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    # 3 images of a 28 x 28 patch grid, left / right halves from two clusters
    bsz, h, w, d = 3, 28, 28, 64
    centers = 6.0 * rng.standard_normal((2, d)).astype(np.float32)
    half = (np.arange(w) >= w // 2).astype(int)  # [w] 0 left, 1 right
    g = np.broadcast_to(half, (bsz, h, w)).reshape(bsz, h * w)
    x = centers[g] + rng.standard_normal((bsz, h * w, d)).astype(np.float32)

    # the debug path starts from the batch-pooled NCut eigenvectors
    flat = torch.from_numpy(x.reshape(bsz * h * w, d)).to(dev)
    ncut_x, eigvals = ncut(flat, num_eig=8, key=Rng(0), num_sample=1024)
    print("NCut eigenvalues:", np.round(eigvals.cpu().numpy(), 4))

    figs, labels = visualize_spectral_debug(
        ncut_x.reshape(bsz, h * w, 8), grid=(h, w), images=3,
        cluster_size_threshold=0.02, min_samples=64, tsne_iters=tsne_iters, show=False,
        save_prefix=os.path.join(args.outdir, "spectral"))
    for name, lab in labels.items():
        agree = (lab == g.reshape(-1)).mean()
        agree = max(agree, 1.0 - agree)  # label permutation
        print(f"{name:>22}: clusters={np.unique(lab).tolist()} half-split agreement="
              f"{agree:.3f}")
    print(f"wrote {len(figs)} figures to {args.outdir}", flush=True)
    return labels


if __name__ == "__main__":
    main()
