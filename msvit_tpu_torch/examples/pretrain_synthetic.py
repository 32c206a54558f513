"""Supervised pretrain on the procedural corpus (counterpart of
`examples/pretrain_synthetic.py`): a ViT trained from scratch at the
geometry the family runs use (ViT-B/8 @224: 784 patch tokens + CLS), whose
checkpoint seeds the multistate bootstrap
(`msvit_tpu_torch.examples.train_multistate --ckpt`).

    python -m msvit_tpu_torch.examples.pretrain_synthetic                 # ViT-B/8 @224
    python -m msvit_tpu_torch.examples.pretrain_synthetic --preset small  # smoke (tiny)
    python -m msvit_tpu_torch.examples.pretrain_synthetic --device cpu --preset small --steps 2

The same flags and defaults as the JAX example, plus ``--device``: the run
is on the CUDA card; ``--device cpu`` is the only way to the CPU (with no
card and no ``--device cpu`` it raises).

`main` writes the JPEG corpus once (`ensure_corpus`, PIL) and loads it;
`pretrain(args, data)` takes a loaded corpus, so a caller can hand it one
made in memory by `generate_batch`.  uint8 batches travel through
`prefetch_to_device`; the normalization, flip and brightness / contrast run
on the device.  AdamW under warmup-cosine behind a global-norm clip
(``--clip``), non-finite steps skipped on the device.

Outputs under --out (default runs/synthetic): corpus<size>/ (shared),
pretrain_<preset>/ckpt, metrics.jsonl and summary.json (the final loss and
the held-out top-1 on fresh generative seeds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from msvit_tpu_torch.data.augment import random_brightness_contrast, random_flip
from msvit_tpu_torch.data.pipeline import prefetch_to_device
from msvit_tpu_torch.data.synthetic import (
    corpus_batches, ensure_corpus, generate_batch, label_classes)
from msvit_tpu_torch.eval import evaluate
from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
from msvit_tpu_torch.settings import parity_policy
from msvit_tpu_torch.train import Trainer, make_optimizer, save_checkpoint
from msvit_tpu_torch.utils.rng import draw_seed, fold_in

PRESETS = {
    # the family runs' trunk geometry: ViT-B/8 @224, 784 patch tokens
    "b8": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               patch_size=8, image_size=224),
    # ViT-S/8: the same 784-token geometry, a quarter of the parameters
    "s8": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=6,
               patch_size=8, image_size=224),
    # 6-layer S/8: the same geometry at half the depth
    "s8d6": dict(hidden_size=384, num_hidden_layers=6, num_attention_heads=6,
                 patch_size=8, image_size=224),
    # ViT-B/16: the cheaper 197-token variant
    "b16": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                patch_size=16, image_size=224),
    # smoke preset (also what the CPU tests use)
    "small": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                  patch_size=16, image_size=64),
}
LABEL_MODES = ("largest", "center", "texture", "ltexture")
HOLDOUT_SEED0 = 10_000_000  # generative seeds no corpus uses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="b8", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--corpus-size", type=int, default=2048)
    ap.add_argument("--eval-size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/synthetic")
    ap.add_argument("--label-mode", default="largest", choices=LABEL_MODES,
                    help="'center': the centered never-occluded object defines "
                    "the label; 'largest': the object with the most visible pixels")
    ap.add_argument("--max-objects", type=int, default=3, help="objects per scene")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--qk-norm", action="store_true",
                    help="per-head q/k LayerNorm: bounds the attention logits, "
                    "the depth-12 from-scratch stabilizer (config.qk_norm)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                    help="compute policy")
    ap.add_argument("--clip", type=float, default=1.0,
                    help="global grad-norm clip (0 disables)")
    ap.add_argument("--layerscale", type=float, default=1e-5,
                    help="LayerScale init, the from-scratch deep-ViT stabilizer")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def warmup_cosine(peak: float, warmup_steps: int,
                  decay_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """`optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps)`: linear from 0 to `peak` over `warmup_steps`, then a cosine
    to 0 at `decay_steps`.  The step is a 0-d tensor (the optimizer's device
    count) or an int; the lr a 0-d f32 tensor on its device, computed in
    optax's order of f32 operations with torch ops only (no host sync)."""
    span = float(max(1, decay_steps - warmup_steps))

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        warm = torch.clamp(step, 0, warmup_steps).float()
        frac = 1.0 - warm / warmup_steps
        rise = (0.0 - peak) * frac + peak
        t = torch.clamp((step - warmup_steps).float(), max=span)
        # the cosine rounded from f64: torch's f32 cos can miss the nearest
        # f32 by an ulp, which 1 + cos magnifies near the end of the decay
        cos = torch.cos((math.pi * t / span).double()).float()
        decay = peak * (0.5 * (1.0 + cos))
        return torch.where(step < warmup_steps, rise, decay)

    return lr


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card "
                           "(pass --device cpu for the CPU)")
    return torch.device(name)


def model_config(args) -> BaseViTConfig:
    policy = {"policy": parity_policy()} if args.dtype == "f32" else {}
    return BaseViTConfig(
        **PRESETS[args.preset], hidden_dropout_prob=0.1,
        layerscale_value=args.layerscale, qk_norm=args.qk_norm, remat=args.remat,
        **policy)


def run_name(args) -> str:
    sfx = "" if args.label_mode == "largest" else f"_{args.label_mode}"
    if args.max_objects != 3:
        sfx += f"_m{args.max_objects}"
    return f"pretrain_{args.preset}{sfx}"


def loss_fn(model, batch, generator):
    """uint8 pixels on the wire, normalized on the device; brightness /
    contrast and flip, then the classifier's cross-entropy.  The
    augmentations draw on the device, dropout from a CPU generator, all
    seeded from `generator` (the JAX example's three-way key split)."""
    pix = batch["pixel_values"]
    base = draw_seed(generator)
    g_aug, g_flip = (torch.Generator(pix.device).manual_seed(fold_in(base, i))
                     for i in (0, 1))
    g_drop = torch.Generator().manual_seed(fold_in(base, 2))
    images = random_flip(
        g_flip, random_brightness_contrast(g_aug, pix.float() / 127.5 - 1.0))
    logits = model(images, generator=g_drop)
    loss = F.cross_entropy(logits, batch["labels"].long())
    return loss, {"loss": loss}


def holdout_batches(hold: Dict[str, np.ndarray], batch: int = 64):
    for lo in range(0, len(hold["labels"]), batch):
        yield {"pixel_values": hold["images"][lo:lo + batch],
               "labels": hold["labels"][lo:lo + batch]}


def pretrain(args, data: Dict[str, np.ndarray], log_every: int = 50) -> dict:
    """Train on the loaded corpus `data` ({"images" [N,S,S,3] uint8,
    "labels" [N]}), evaluate on held-out scenes, write the checkpoint,
    `metrics.jsonl` and `summary.json`; returns the summary."""
    dev = resolve_device(args.device)
    geom = PRESETS[args.preset]
    size = geom["image_size"]
    num_classes = len(label_classes(args.label_mode))
    run_dir = os.path.join(args.out, run_name(args))
    os.makedirs(run_dir, exist_ok=True)

    model = ViTForImageClassification(
        model_config(args), num_classes,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = (size // geom["patch_size"]) ** 2
    print(f"preset {args.preset}: {n_params / 1e6:.1f}M params, "
          f"{tokens} patch tokens, corpus {len(data['labels'])}", flush=True)

    schedule = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    optimizer = make_optimizer(schedule, weight_decay=args.weight_decay,
                               clip_norm=args.clip if args.clip > 0 else None)
    trainer = Trainer(loss_fn, optimizer, model.train(), monitor=True,
                      log_every=log_every,
                      metrics_path=os.path.join(run_dir, "metrics.jsonl"))

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    host = corpus_batches(data, args.batch, seed=args.seed, uint8=True)
    with contextlib.closing(prefetch_to_device(host, device=dev)) as batches:
        final_loss = trainer.fit(batches, num_steps=args.steps, seed=args.seed)
    sync()
    dt = time.perf_counter() - t0
    print(f"trained {trainer.step} steps in {dt:.1f}s "
          f"({trainer.step * args.batch / dt:.0f} img/s), "
          f"final loss {final_loss:.4f}", flush=True)

    # held-out eval: fresh generative seeds the corpus never used
    hold = generate_batch(range(HOLDOUT_SEED0, HOLDOUT_SEED0 + args.eval_size),
                          size=size, label_mode=args.label_mode,
                          max_objects=args.max_objects)
    res = evaluate(lambda m, pix: m(pix.float() / 127.5 - 1.0), model.eval(),
                   holdout_batches(hold), topk=(1,))
    print(f"held-out top-1: {res['top1_acc']:.4f} (n={res['n']:.0f}, "
          f"chance {1.0 / num_classes:.3f})", flush=True)

    if final_loss != final_loss:  # NaN: never clobber a good checkpoint
        raise FloatingPointError("final loss is NaN: no checkpoint saved")
    save_checkpoint(os.path.join(run_dir, "ckpt"), trainer.step,
                    {"params": model.state_dict()})
    summary = {
        "preset": args.preset, "label_mode": args.label_mode,
        "steps": trainer.step, "batch": args.batch,
        "final_loss": float(final_loss), "holdout_top1": float(res["top1_acc"]),
        "train_sec": dt, "params_m": n_params / 1e6,
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"checkpoint + summary under {run_dir}", flush=True)
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raise before the corpus is written
    data = ensure_corpus(args.out, args.corpus_size,
                         size=PRESETS[args.preset]["image_size"], seed=args.seed,
                         label_mode=args.label_mode, max_objects=args.max_objects)
    return pretrain(args, data)


if __name__ == "__main__":
    main()
