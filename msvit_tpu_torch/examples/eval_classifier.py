"""Classifier evaluation and an augmented fine-tune (counterpart of
`examples/eval_classifier.py`): top-1/top-5 over synthetic batches (or a
local image folder) through the eval loop, then a few mixup/cutmix steps
(soft-target cross entropy) over the same batches.

    python -m msvit_tpu_torch.examples.eval_classifier [--batch 32] [--classes 10]
    python -m msvit_tpu_torch.examples.eval_classifier --dataset path/to/folder
    python -m msvit_tpu_torch.examples.eval_classifier --device cpu --batch 4 --steps 2

The JAX example's flags and model (a ViT-Tiny-like 192 x 4, 3 heads, at
224 px, patch 16).  ``--dataset`` takes what `datasets.load_dataset`
takes: a local directory is read as an image folder (class sub-folders give
the labels) through `data.pipeline.load_image_batches` (native JPEG decode,
uint8 wire, normalization on the device); labels are taken modulo
``--classes``.  Synthetic batches are seeded normal pixels and random
labels.  It runs on the CUDA card; ``--device cpu`` is the only way to the
CPU (with no card and no ``--device cpu`` it raises).
"""

from __future__ import annotations

import argparse
import itertools
from typing import List, Optional

import torch
import torch.nn.functional as F

from msvit_tpu_torch.data.augment import cutmix, mixup
from msvit_tpu_torch.data.pipeline import ImagePipelineConfig, load_image_batches
from msvit_tpu_torch.eval import evaluate
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
from msvit_tpu_torch.train import make_optimizer, train_step_fn


def tiny_config() -> BaseViTConfig:
    return BaseViTConfig(hidden_size=192, num_hidden_layers=4, num_attention_heads=3,
                         image_size=224, patch_size=16)


def main(argv: Optional[List[str]] = None,
         config: Optional[BaseViTConfig] = None) -> dict:
    """Evaluate, then fine-tune; returns the eval metrics and the losses.
    `config` replaces the model config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3,
                    help="fine-tune steps; they cycle over the eval batches")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dataset", default=None,
                    help="a local image folder (or a dataset id for datasets.load_dataset)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config or tiny_config()
    s = cfg.image_size

    model = ViTForImageClassification(
        cfg, args.classes, generator=torch.Generator().manual_seed(0), device=dev)

    def batches() -> List[dict]:
        if args.dataset:
            loader = load_image_batches(args.dataset, batch_size=args.batch,
                                        config=ImagePipelineConfig(image_size=s), device=dev)
            try:
                return [{"pixel_values": b["pixel_values"],
                         "labels": b["labels"].long() % args.classes}
                        for b in itertools.islice(loader, args.eval_batches)]
            finally:
                loader.close()
        g = torch.Generator().manual_seed(0)
        return [{"pixel_values": torch.randn(args.batch, s, s, 3, generator=g).to(dev),
                 "labels": torch.randint(0, args.classes, (args.batch,), generator=g).to(dev)}
                for _ in range(args.eval_batches)]

    data = batches()
    if not data:
        raise ValueError(f"no full batch of {args.batch} in {args.dataset!r}")
    model.eval()
    metrics = evaluate(lambda m, x: m(x), model, data, topk=(1, 5))
    print(f"eval: n={metrics['n']:.0f} loss={metrics['loss']:.4f} "
          f"top1={metrics['top1_acc']:.4f} top5={metrics['top5_acc']:.4f} ({dev})", flush=True)

    def loss_fn(m, batch, gen):
        x, y_soft = batch
        return torch.sum(-y_soft * F.log_softmax(m(x), -1), -1).mean(), {}

    opt = make_optimizer(args.lr, weight_decay=1e-4)  # optax.adamw(lr)
    state = opt.init(model)
    step = train_step_fn(loss_fn, opt)
    model.train()
    losses = []
    # the steps cycle over the fixed batches: with steps > eval-batches the
    # fine-tune revisits the same images, so the loss falls
    for i, b in enumerate(itertools.islice(itertools.cycle(data), args.steps)):
        g = torch.Generator().manual_seed(7 + i)
        aug = mixup if i % 2 == 0 else cutmix
        x, y = aug(g, b["pixel_values"], b["labels"], num_classes=args.classes)
        loss, _ = step(model, state, (x, y), g)
        losses.append(float(loss))
        print(f"step {i}: {'mixup' if i % 2 == 0 else 'cutmix'} loss {losses[-1]:.4f}",
              flush=True)
    if losses:
        print(f"augmented fine-tune loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return {"eval": metrics, "losses": losses}


if __name__ == "__main__":
    main()
