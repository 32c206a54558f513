"""Predictive training (counterpart of `examples/train_predictive.py`): the
reference sandbox's scaling glimpses (patch 64, scale rows ((1, 0), (1, 0),
(1, -1)), no CLS), losses {context_patch 1e-4, query_patch 1.0, pos_reg
0.5}, AdamW(2e-3) at optax's `adamw` defaults.

    python -m msvit_tpu_torch.examples.train_predictive [--steps 10] [--batch 64]
    python -m msvit_tpu_torch.examples.train_predictive --pretrained DIR
    python -m msvit_tpu_torch.examples.train_predictive --device cpu --steps 2 --batch 2

The same flags and defaults as the JAX example, plus ``--device``: it runs
on the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).  Step i trains on N(0, 1) images drawn
from seed 1000 + i, or on the next batch of ``--dataset`` (a local image
folder; a hub dataset only with network); its glimpses draw from an
`Rng` seeded by a generator seeded with i.  ``--pretrained`` imports an HF
checkpoint's trunk and CLS token (`import_into_predictive`; the glimpse
tokenizer is never pretrained).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from msvit_tpu_torch.compat import import_into_predictive, load_state_dict_from
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.examples.train_predictive_synthetic import sandbox_config, training_config
from msvit_tpu_torch.models.predictive import PredictiveViTConfig, PredictiveViTModel, training_loss
from msvit_tpu_torch.train import make_optimizer, train_step_fn
from msvit_tpu_torch.utils.rng import Rng, draw_seed

SEED = 1212


def main(argv: Optional[List[str]] = None,
         config: Optional[PredictiveViTConfig] = None) -> List[float]:
    """Train; returns the per-step losses.  `config` replaces the sandbox
    config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dataset", default=None,
                    help="a local image folder (or a dataset id for datasets.load_dataset)")
    ap.add_argument("--pretrained", default=None,
                    help="checkpoint path, HF-layout dir, or HF hub id (hub needs network)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config or sandbox_config()
    tc = training_config("sandbox")
    model = PredictiveViTModel(cfg, generator=torch.Generator().manual_seed(SEED),
                               device=dev).train()
    if args.pretrained:
        sd = load_state_dict_from(args.pretrained)
        model.load_state_dict(import_into_predictive(sd, cfg, model.state_dict()))

    loader = None
    if args.dataset:
        from msvit_tpu_torch.data.pipeline import ImagePipelineConfig, load_image_batches

        loader = load_image_batches(args.dataset, batch_size=args.batch, shuffle_seed=0,
                                    config=ImagePipelineConfig(image_size=cfg.image_size),
                                    device=dev)

    def batch(i: int) -> torch.Tensor:
        if loader is not None:
            return next(loader)["pixel_values"]
        s = cfg.image_size
        return torch.randn(args.batch, s, s, cfg.num_channels,
                           generator=torch.Generator().manual_seed(1000 + i)).to(dev)

    def loss_fn(model, pix, generator):
        out = model(pix, rng=Rng(draw_seed(generator)), output_inputs=True)
        err, losses, _ = training_loss(model, pix, out, tc)
        return err.mean(), {k: v.detach().mean() for k, v in losses.items()}

    optimizer = make_optimizer(2e-3, weight_decay=1e-4)  # optax.adamw(2e-3)
    step, opt_state = train_step_fn(loss_fn, optimizer), optimizer.init(model)
    losses_out = []
    try:
        for i in range(args.steps):
            loss, losses = step(model, opt_state, batch(i), torch.Generator().manual_seed(i))
            losses_out.append(float(loss))
            parts = "  ".join(f"{k}={float(v):.4f}" for k, v in losses.items())
            print(f"iter {i}: loss {losses_out[-1]:.4f}  ({parts})", flush=True)
    finally:
        if loader is not None:
            loader.close()
    print("done", flush=True)
    return losses_out


if __name__ == "__main__":
    main()
