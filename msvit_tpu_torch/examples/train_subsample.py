"""Subsample REINFORCE training (counterpart of `examples/train_subsample.py`,
the reference sandbox's workflow): a 6-layer trunk, grid 4, the policy
alone trained by AdamW(1e-3), loss = the batch-standardised CE times the
episode's log-probability (`reinforce_loss`).

    python -m msvit_tpu_torch.examples.train_subsample [--steps 20] [--batch 32]
    python -m msvit_tpu_torch.examples.train_subsample --pretrained DIR
    python -m msvit_tpu_torch.examples.train_subsample --device cpu --steps 2 --batch 2

The same flags and defaults as the JAX example, plus ``--device``: it runs
on the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).  Seeded N(0, 1) images and random
labels by default (a new batch each step from one generator seeded 0);
``--dataset`` streams a local image folder (a hub dataset only with
network).  ``--pretrained`` loads an HF checkpoint's trunk, patch
projection, position table and CLS token (`import_into_subsample`).
``--visualize-every k`` writes `subsample_<i>.png` (the quadtree heat map,
`viz.visualize_subsample_output`; matplotlib needed) every k steps into the
working directory.  Step i's policy draws from `Rng(i)`.
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Optional

import torch

from msvit_tpu_torch.compat import import_into_subsample, load_state_dict_from
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.subsample import (
    SubsampleViTConfig, SubsampleViTForImageClassification, reinforce_loss)
from msvit_tpu_torch.train import make_optimizer, train_step_fn
from msvit_tpu_torch.utils.rng import Rng, draw_seed

SEED = 1212


def default_config() -> SubsampleViTConfig:
    return SubsampleViTConfig(num_hidden_layers=6, image_size=224, patch_size=14,
                              initial_grid_size=4, multiplicative_grid_size=2,
                              nesting_mode="open", max_depth=1, num_labels=1000)


def main(argv: Optional[List[str]] = None,
         config: Optional[SubsampleViTConfig] = None) -> List[float]:
    """Train; returns the per-step REINFORCE losses.  `config` replaces the
    model config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dataset", default=None,
                    help="a local image folder (or a dataset id for datasets.load_dataset)")
    ap.add_argument("--visualize-every", type=int, default=0)
    ap.add_argument("--pretrained", default=None,
                    help="checkpoint path, HF-layout dir, or HF hub id (hub needs network)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config or default_config()
    model = SubsampleViTForImageClassification(
        cfg, generator=torch.Generator().manual_seed(SEED), device=dev).train()
    if args.pretrained:
        sd = load_state_dict_from(args.pretrained)
        model.load_state_dict(import_into_subsample(sd, cfg, model.state_dict()))

    def batches() -> Iterator[dict]:
        if args.dataset:
            from msvit_tpu_torch.data.pipeline import ImagePipelineConfig, load_image_batches

            yield from load_image_batches(
                args.dataset, batch_size=args.batch, shuffle_seed=0, device=dev,
                config=ImagePipelineConfig(image_size=cfg.image_size))
            return
        g, s = torch.Generator().manual_seed(0), cfg.image_size
        while True:
            yield {"pixel_values": torch.randn(args.batch, s, s, cfg.num_channels,
                                               generator=g).to(dev),
                   "labels": torch.randint(0, cfg.num_labels, (args.batch,),
                                           generator=g).to(dev)}

    def loss_fn(model, batch, generator):
        out = model(batch["pixel_values"], batch["labels"].long(),
                    rng=Rng(draw_seed(generator)))
        return reinforce_loss(out["loss"], out["log_prob"]), {"ce": out["loss"].mean().detach()}

    # the subdivision policy alone trains
    def trainable(path) -> bool:
        return "projection" in path

    for name, p in model.named_parameters():
        p.requires_grad_(trainable(tuple(name.split("."))))
    optimizer = make_optimizer(1e-3, trainable=trainable)
    step, opt_state = train_step_fn(loss_fn, optimizer), optimizer.init(model)
    it = batches()
    losses = []
    try:
        for i in range(args.steps):
            batch = next(it)
            loss, aux = step(model, opt_state, batch, torch.Generator().manual_seed(i))
            losses.append(float(loss))
            if i % 5 == 0:
                print(f"iter {i}: normalized loss {losses[-1]:+.4f}  mean CE "
                      f"{float(aux['ce']):.4f}", flush=True)
            if args.visualize_every and i % args.visualize_every == 0:
                from msvit_tpu_torch.viz import visualize_subsample_output

                with torch.no_grad():
                    out = model(batch["pixel_values"], batch["labels"].long(),
                                rng=Rng(i), output_logs=True, return_pixel_values=True)
                visualize_subsample_output(out, model.model.tree, show=False,
                                           save_path=f"subsample_{i}.png")
    finally:
        it.close()
    print("done", flush=True)
    return losses


if __name__ == "__main__":
    main()
