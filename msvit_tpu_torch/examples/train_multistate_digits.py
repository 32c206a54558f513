"""Multistate on real data, offline (counterpart of
`examples/train_multistate_digits.py`):

  1. train a small base ViT classifier on the scikit-learn digits set (as
     `train_digits`);
  2. bootstrap the multistate encoder from it: patch embedding, position
     table and trunk layers copied, the TX/RX tokens from the trained CLS
     token (`compat.family.transfer_base_to_multistate`);
  3. fine-tune the policy with the trunk frozen: only the TX/RX tokens and
     the linear head over the occupancy-pooled TX tokens train
     (``--unfreeze`` trains everything);
  4. report the test accuracy of the base model and of the multistate one.

    python -m msvit_tpu_torch.examples.train_multistate_digits
    python -m msvit_tpu_torch.examples.train_multistate_digits --steps 120 --ms-steps 120
    python -m msvit_tpu_torch.examples.train_multistate_digits --device cpu --steps 2 --ms-steps 2

The JAX example's flags and defaults: ViT 256 x 6 on 32 px, patch 4; the
multistate model with spectral clustering (NCut dim 4, 64 anchors, up to 8
clusters) first after 2 layers and every 2 after.  On the card the
multistate forward runs K4/K5 (inference) and K5-lse/K6 (training) under
the cluster masks.  It runs on the CUDA card; ``--device cpu`` is the only
way to the CPU (with no card and no ``--device cpu`` it raises).  Needs
scikit-learn.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from msvit_tpu_torch.compat.family import transfer_base_to_multistate
from msvit_tpu_torch.data.augment import random_brightness_contrast
from msvit_tpu_torch.data.digits import eval_batches, load_digits_arrays
from msvit_tpu_torch.eval import evaluate
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device, warmup_cosine
from msvit_tpu_torch.examples.train_digits import NUM_CLASSES, device_batches, logits_fn
from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import (
    MultiStateViTConfig, MultiStateViTForImageClassification)
from msvit_tpu_torch.train import Trainer, make_optimizer
from msvit_tpu_torch.utils.rng import Rng, draw_seed

TRAINABLE = ("transmitter_token", "receiver_token", "classifier")


def digits_configs() -> Tuple[BaseViTConfig, MultiStateViTConfig]:
    """The JAX example's base trunk and its multistate counterpart."""
    geom = dict(hidden_size=256, num_hidden_layers=6, num_attention_heads=4, image_size=32,
                patch_size=4)
    return (BaseViTConfig(**geom, hidden_dropout_prob=0.1),
            MultiStateViTConfig(**geom, pregeneration_period=2, generation_period=2,
                                clustering=SpectralClusteringConfig(
                                    ncut_dim=4, num_sample=64, max_clusters=8,
                                    eigenvalue_threshold=0.1, ncut_dist="rbf")))


def main(argv: Optional[List[str]] = None,
         configs: Optional[Tuple[BaseViTConfig, MultiStateViTConfig]] = None) -> dict:
    """Run the four stages; returns both accuracies.  `configs` replaces the
    (base, multistate) configs (the tests pass tiny ones)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600, help="base ViT steps")
    ap.add_argument("--ms-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ms-lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--unfreeze", action="store_true",
                    help="fine-tune the whole multistate model, not just TX/RX + head")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, ms_cfg = configs or digits_configs()
    data = load_digits_arrays(image_size=cfg.image_size, seed=args.seed)
    print(f"digits: {len(data['train_images'])} train / {len(data['test_images'])} test",
          flush=True)

    # ---- 1: the base ViT (the trunk of train_digits) ----
    model = ViTForImageClassification(
        cfg, NUM_CLASSES, generator=torch.Generator().manual_seed(args.seed), device=dev)
    model.train()

    def base_loss(m, batch, gen):
        images, labels = batch
        images = random_brightness_contrast(gen, images)
        loss = F.cross_entropy(m(images, generator=gen), labels)
        return loss, {"loss": loss.detach()}

    sched = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    trainer = Trainer(base_loss, make_optimizer(sched, weight_decay=0.05), model, log_every=100)
    t0 = time.perf_counter()
    trainer.fit(device_batches(data["train_images"], data["train_labels"], args.batch,
                               args.seed, args.steps, dev), num_steps=args.steps, seed=args.seed)
    print(f"base trained {args.steps} steps in {time.perf_counter() - t0:.1f}s ({dev})",
          flush=True)

    def test():
        return eval_batches(data["test_images"], data["test_labels"], 256)

    model.eval()
    base_acc = evaluate(logits_fn, model, test(), topk=(1,))["top1_acc"]
    print(f"base ViT test top-1: {base_acc:.4f}", flush=True)

    # ---- 2: bootstrap the multistate encoder from the trained trunk ----
    ms_model = MultiStateViTForImageClassification(
        ms_cfg, NUM_CLASSES, generator=torch.Generator().manual_seed(args.seed), device=dev)
    base = {k[len("vit."):]: v for k, v in model.state_dict().items() if k.startswith("vit.")}
    ms_model.encoder.load_state_dict(transfer_base_to_multistate(
        base, ms_model.encoder.state_dict(), ms_cfg.num_hidden_layers))

    # ---- 3: the policy fine-tune (trunk frozen) ----
    def trainable(path) -> bool:
        return args.unfreeze or any(n in TRAINABLE for n in path)

    for name, p in ms_model.named_parameters():
        p.requires_grad_(trainable(tuple(name.split("."))))

    def ms_loss(m, batch, gen):
        images, labels = batch
        out = m(images, labels, rng=Rng(draw_seed(gen)), generator=gen)
        acc = (out["logits"].argmax(-1) == labels).float().mean()
        return out["loss"], {"acc": acc.detach()}

    ms_model.train()
    ms_trainer = Trainer(ms_loss, make_optimizer(args.ms_lr, trainable=trainable), ms_model,
                         log_every=100)
    t0 = time.perf_counter()
    ms_trainer.fit(device_batches(data["train_images"], data["train_labels"], args.batch,
                                  args.seed + 1, args.ms_steps, dev),
                   num_steps=args.ms_steps, seed=args.seed + 7)
    print(f"multistate fine-tuned {args.ms_steps} steps "
          f"({'full' if args.unfreeze else 'TX/RX + head only'}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # ---- 4: accuracies ----
    ms_model.eval()
    eval_rng = Rng(123)
    ms_acc = evaluate(lambda m, pix: m(pix, rng=eval_rng)["logits"], ms_model, test(),
                      topk=(1,))["top1_acc"]
    print(f"multistate test top-1: {ms_acc:.4f} (base {base_acc:.4f}, "
          f"delta {ms_acc - base_acc:+.4f})", flush=True)
    return {"base_top1": base_acc, "multistate_top1": ms_acc}


if __name__ == "__main__":
    main()
