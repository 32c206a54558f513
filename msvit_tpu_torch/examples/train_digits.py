"""End-to-end real-data workflow, offline (counterpart of
`examples/train_digits.py`): train a small ViT classifier on the digits set
bundled with scikit-learn, evaluate it (raw and EMA weights), then quantize
the trained trunk to int8 and score the int8 model on the same test set.

    python -m msvit_tpu_torch.examples.train_digits                 # 900 steps
    python -m msvit_tpu_torch.examples.train_digits --steps 120     # a quick pass
    python -m msvit_tpu_torch.examples.train_digits --device cpu --steps 2

The JAX example's flags and defaults: ViT 256 x 6 (dh 64) on 32 px, patch 4
(64 patches + CLS), bs128, AdamW (weight decay 0.05) under warmup-cosine,
brightness/contrast and mixup (alpha 0.1), dropout 0.1, an EMA of the
weights (0.99), non-finite steps skipped (`Trainer(monitor=True)`).  The
int8 trunk (`quantize_vit_params`, scales calibrated on 256 training
images) runs K3 in every layer on the card; the f32 head stays.  It runs
on the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).  Needs scikit-learn.
"""

from __future__ import annotations

import argparse
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msvit_tpu_torch.data.augment import mixup, random_brightness_contrast
from msvit_tpu_torch.data.digits import eval_batches, iter_epochs, load_digits_arrays
from msvit_tpu_torch.eval import evaluate
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device, warmup_cosine
from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
from msvit_tpu_torch.models.base.quantized import (
    calibrate_act_scales, quantize_vit_params, quantized_vit_apply)
from msvit_tpu_torch.train import Trainer, make_optimizer

NUM_CLASSES = 10


def digits_config() -> BaseViTConfig:
    """The JAX example's trunk: D 256 (dh 64), 6 layers, 32 px, patch 4."""
    return BaseViTConfig(hidden_size=256, num_hidden_layers=6, num_attention_heads=4,
                         image_size=32, patch_size=4, hidden_dropout_prob=0.1)


def device_batches(images: np.ndarray, labels: np.ndarray, batch: int, seed: int,
                   steps: int, dev: torch.device) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """`iter_epochs` (the JAX package's epoch order), sent to the device."""
    for x, y in iter_epochs(images, labels, batch, seed=seed, max_steps=steps):
        yield (torch.from_numpy(x).to(dev, non_blocking=True),
               torch.from_numpy(y).to(dev, non_blocking=True).long())


def logits_fn(model, pix):
    return model(pix)


def ema_model(trainer: Trainer, cfg: BaseViTConfig, dev) -> ViTForImageClassification:
    """A copy of the trained classifier holding the EMA weights."""
    model = ViTForImageClassification(cfg, NUM_CLASSES, device=dev).eval()
    model.load_state_dict({**trainer.model.state_dict(), **trainer.ema_params})
    return model


def main(argv: Optional[List[str]] = None,
         config: Optional[BaseViTConfig] = None) -> dict:
    """Train, evaluate, quantize and evaluate; returns the accuracies and
    the final loss.  `config` replaces the trunk (the tests pass a tiny
    one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--mixup", type=float, default=0.1, help="alpha; 0 = off")
    # decay 0.99 is a ~100-step window: right for a ~1k-step run
    ap.add_argument("--ema", type=float, default=0.99)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-int8", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config or digits_config()
    data = load_digits_arrays(image_size=cfg.image_size, seed=args.seed)
    n_train, n_test = len(data["train_images"]), len(data["test_images"])
    print(f"digits: {n_train} train / {n_test} test, {cfg.image_size}x{cfg.image_size}x3, "
          f"{NUM_CLASSES} classes", flush=True)
    model = ViTForImageClassification(
        cfg, NUM_CLASSES, generator=torch.Generator().manual_seed(args.seed), device=dev)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: ViT {cfg.hidden_size}x{cfg.num_hidden_layers} (dh={cfg.head_dim}), "
          f"{n_params / 1e6:.2f}M params", flush=True)

    def loss_fn(m, batch, gen):
        images, labels = batch
        images = random_brightness_contrast(gen, images)
        if args.mixup > 0:
            images, targets = mixup(gen, images, labels, num_classes=NUM_CLASSES,
                                    alpha=args.mixup)
        else:
            targets = F.one_hot(labels, NUM_CLASSES).float()
        logits = m(images, generator=gen)
        loss = torch.sum(-targets * F.log_softmax(logits, -1), -1).mean()
        return loss, {"loss": loss.detach()}

    sched = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    trainer = Trainer(loss_fn, make_optimizer(sched, weight_decay=args.weight_decay), model,
                      monitor=True, ema_decay=args.ema if args.ema > 0 else None,
                      log_every=100)
    t0 = time.perf_counter()
    final_loss = trainer.fit(
        device_batches(data["train_images"], data["train_labels"], args.batch, args.seed,
                       args.steps, dev), num_steps=args.steps, seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"trained {trainer.step} steps in {dt:.1f}s ({trainer.step * args.batch / dt:.0f} "
          f"img/s, {dev}), final loss {final_loss:.4f}", flush=True)

    def test():
        return eval_batches(data["test_images"], data["test_labels"], 256)

    model.eval()
    raw = evaluate(logits_fn, model, test(), topk=(1,))
    print(f"test top-1 (raw params): {raw['top1_acc']:.4f}  (n={raw['n']:.0f})", flush=True)
    serve = model
    ema = raw
    if trainer.ema_params is not None:
        serve = ema_model(trainer, cfg, dev)
        ema = evaluate(logits_fn, serve, test(), topk=(1,))
        print(f"test top-1 (EMA params): {ema['top1_acc']:.4f}", flush=True)
    out = {"final_loss": final_loss, "raw_top1": raw["top1_acc"], "ema_top1": ema["top1_acc"]}
    if args.skip_int8:
        return out

    # int8 post-training quantization of the trained trunk; f32 head
    qtrunk = quantize_vit_params(serve.vit)
    calib = torch.from_numpy(data["train_images"][:256]).to(dev)
    scales = calibrate_act_scales(qtrunk, cfg, calib)
    head = serve.classifier

    def int8_logits(_, pix):
        feats = quantized_vit_apply(qtrunk, cfg, pix, act_scales=scales)
        return F.linear(feats[:, 0].float(), head.weight.float(), head.bias.float())

    q = evaluate(int8_logits, serve, test(), topk=(1,))
    print(f"test top-1 (int8 trunk, trained weights): {q['top1_acc']:.4f}  "
          f"(drop vs EMA: {ema['top1_acc'] - q['top1_acc']:+.4f})", flush=True)
    out["int8_top1"] = q["top1_acc"]
    return out


if __name__ == "__main__":
    main()
