"""Multistate at 224 px / 784 tokens on trained features, with cluster-vs-
region metrics (counterpart of `examples/train_multistate_synthetic.py`).

The trunk comes from `pretrain_synthetic --preset b8` (the geometry of the
reference's dino-vitb8 bootstrap, trained on the procedural corpus) and is
wired into the multistate encoder (`transfer_base_to_multistate`).  The
corpus gives exact region masks, so the cluster assignments are scored by
ARI and NMI (scikit-learn) against patch-majority region labels, beside an
untrained-trunk control and a random-partition control.

    python -m msvit_tpu_torch.examples.train_multistate_synthetic                 # full
    python -m msvit_tpu_torch.examples.train_multistate_synthetic --eval-size 16  # quick
    python -m msvit_tpu_torch.examples.train_multistate_synthetic --preset small --device cpu

The same flags and defaults as the JAX example, plus ``--device``: it runs
on the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).  It needs scikit-learn and matplotlib
(the card's machine has neither: run it on the CPU there).  The untrained
trunk is drawn from ``--seed``; batch ``lo`` clusters with
`Rng(fold_in(7, lo))`.  Outputs under ``--out/multistate[_<mode>]``:
clusters.png (image / regions / cluster-map triptychs) and summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from msvit_tpu_torch.compat import transfer_base_to_multistate
from msvit_tpu_torch.data.synthetic import generate_batch
from msvit_tpu_torch.examples.pretrain_synthetic import PRESETS, resolve_device
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import MultiStateViTConfig, MultiStateViTEncoderModel
from msvit_tpu_torch.train import restore_checkpoint
from msvit_tpu_torch.utils.rng import Rng, fold_in


def patch_region_labels(regions: np.ndarray, patch: int) -> np.ndarray:
    """[B, S, S] pixel region ids -> [B, (S // p)^2] patch-majority labels."""
    b, s, _ = regions.shape
    g = s // patch
    r = regions[:, : g * patch, : g * patch].reshape(b, g, patch, g, patch)
    r = r.transpose(0, 1, 3, 2, 4).reshape(b, g * g, patch * patch)
    out = np.zeros((b, g * g), np.int32)
    for i in range(b):
        for j in range(g * g):
            out[i, j] = np.bincount(r[i, j]).argmax()
    return out


def cluster_scores(cluster_indices: np.ndarray, region_labels: np.ndarray):
    """Mean ARI and NMI over the batch."""
    from sklearn.metrics import adjusted_rand_score, normalized_mutual_info_score

    aris = [adjusted_rand_score(rl, ci) for ci, rl in zip(cluster_indices, region_labels)]
    nmis = [normalized_mutual_info_score(rl, ci)
            for ci, rl in zip(cluster_indices, region_labels)]
    return float(np.mean(aris)), float(np.mean(nmis))


def config_for(preset: str, qk_norm: bool = False) -> MultiStateViTConfig:
    """The sandbox multistate config at a pretrain preset's geometry (the
    smoke geometry for "small")."""
    geom = dict(PRESETS[preset])
    if preset == "small":
        clus, pregen, gen = dict(ncut_dim=4, num_sample=16, max_clusters=4), 1, 1
    else:
        clus, pregen, gen = dict(ncut_dim=8, num_sample=1024, max_clusters=16), 4, 2
        geom["qk_norm"] = qk_norm
    return MultiStateViTConfig(
        **geom, pregeneration_period=pregen, generation_period=gen,
        clustering=SpectralClusteringConfig(
            **clus, eigenvalue_threshold=0.1, ncut_dist="rbf", eig_method="subspace",
            late_num_sample=min(256, clus["num_sample"])))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="pretrain_synthetic checkpoint dir (default "
                    "<out>/pretrain_<preset>/ckpt)")
    ap.add_argument("--preset", default="b8", choices=["b8", "s8", "s8d6", "small"])
    ap.add_argument("--eval-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/synthetic")
    ap.add_argument("--qk-norm", action="store_true",
                    help="the trunk was pretrained with config.qk_norm")
    ap.add_argument("--label-mode", default="largest",
                    choices=["largest", "center", "texture", "ltexture"],
                    help="the trunk's pretrain corpus")
    ap.add_argument("--max-objects", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sfx = "" if args.label_mode == "largest" else f"_{args.label_mode}"
    if args.max_objects != 3:
        sfx += f"_m{args.max_objects}"
    run_dir = os.path.join(args.out, f"multistate{sfx}")
    os.makedirs(run_dir, exist_ok=True)
    ckpt = args.ckpt or os.path.join(args.out, f"pretrain_{args.preset}{sfx}", "ckpt")

    cfg = config_for(args.preset, args.qk_norm)
    size, patch = cfg.image_size, cfg.patch_size
    params = restore_checkpoint(ckpt)["params"]
    base = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
    print(f"restored trunk from {ckpt}", flush=True)
    untrained = MultiStateViTEncoderModel(
        cfg, generator=torch.Generator().manual_seed(args.seed), device=dev).eval()
    trained = MultiStateViTEncoderModel(cfg, device=dev).eval()
    trained.load_state_dict(transfer_base_to_multistate(
        base, untrained.state_dict(), cfg.num_hidden_layers))

    hold = generate_batch(range(30_000_000, 30_000_000 + args.eval_size), size=size,
                          label_mode=args.label_mode, max_objects=args.max_objects)
    pix = hold["images"].astype(np.float32) / 127.5 - 1.0
    region_patches = patch_region_labels(hold["regions"], patch)

    def run(model, tag):
        cis = []
        with torch.inference_mode():
            for lo in range(0, args.eval_size, args.batch):
                out = model(torch.from_numpy(pix[lo: lo + args.batch]).to(dev),
                            rng=Rng(fold_in(7, lo)))
                cis.append(out["last_cluster_indices"].cpu().numpy())
        ci = np.concatenate(cis)
        ari, nmi = cluster_scores(ci, region_patches)
        ncl = float(np.mean([len(np.unique(c)) for c in ci]))
        print(f"{tag:18s}: ARI {ari:+.4f}  NMI {nmi:.4f}  (mean clusters {ncl:.1f})",
              flush=True)
        return ci, ari, nmi, ncl

    ci_tr, ari_tr, nmi_tr, ncl_tr = run(trained, "trained trunk")
    _, ari_un, nmi_un, ncl_un = run(untrained, "untrained trunk")
    # the random-partition control, at the trained run's cluster counts
    rng_np = np.random.default_rng(0)
    rand_ci = np.stack([rng_np.integers(0, max(len(np.unique(c)), 1), size=c.shape)
                        for c in ci_tr])
    ari_rd, nmi_rd = cluster_scores(rand_ci, region_patches)
    print(f"{'random partition':18s}: ARI {ari_rd:+.4f}  NMI {nmi_rd:.4f}", flush=True)

    # the triptychs: image / ground-truth regions / clusters
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    g = size // patch
    n_show = min(4, args.eval_size)
    fig, axes = plt.subplots(n_show, 3, figsize=(9, 3 * n_show), squeeze=False)
    for i in range(n_show):
        axes[i, 0].imshow(hold["images"][i])
        axes[i, 0].set_title("image" if i == 0 else None)
        axes[i, 1].imshow(region_patches[i].reshape(g, g), cmap="tab20")
        axes[i, 1].set_title("regions (patch)" if i == 0 else None)
        axes[i, 2].imshow(ci_tr[i].reshape(g, g), cmap="tab20")
        axes[i, 2].set_title("clusters" if i == 0 else None)
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(run_dir, "clusters.png"), dpi=110)
    plt.close(fig)

    summary = {"eval_size": args.eval_size, "label_mode": args.label_mode,
               "device": str(dev),
               "trained": {"ari": ari_tr, "nmi": nmi_tr, "clusters": ncl_tr},
               "untrained": {"ari": ari_un, "nmi": nmi_un, "clusters": ncl_un},
               "random": {"ari": ari_rd, "nmi": nmi_rd}}
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"figure + summary under {run_dir}", flush=True)
    return summary


if __name__ == "__main__":
    main()
