"""Saccadic training (counterpart of `examples/train_saccadic.py`):

1. collect glimpse embeddings with the batched lockstep controller
   (`batched_saccade_run`) over a batch of images;
2. split each image's trace into context (its first ``--context``
   glimpses) and hidden (the rest) pools;
3. fit the pattern bank (`pattern_nll_loss`) and the transformer refiner
   (`refiner_preservation_loss`) to them with AdamW at optax's
   `adamw(lr)` defaults (weight decay 1e-4).

    python -m msvit_tpu_torch.examples.train_saccadic [--steps 10] [--batch 8]
    python -m msvit_tpu_torch.examples.train_saccadic --device cpu --steps 2

The images are the JAX example's synthetic default, standard-normal
pixels drawn on the CPU from ``--seed``, or with ``--dataset`` the first
batch of `data.pipeline.load_image_batches` (a local image folder, decoded
natively and normalized on the device).  The run is on the CUDA card;
``--device cpu`` is the only way to the CPU (with no card and no
``--device cpu`` it raises).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.examples.train_multistate import dataset_batch
from msvit_tpu_torch.models.saccadic import (
    SaccadicViTConfig, SaccadicViTEmbeddings, SaccadicViTMultiStatePattern,
    TransformerSaccadicViTPredictor, batched_saccade_run, pattern_nll_loss,
    refiner_preservation_loss)
from msvit_tpu_torch.train import make_optimizer, train_step_fn


def train_config(**overrides) -> SaccadicViTConfig:
    kw = dict(hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
              num_patterns=((1, 64), (2, 64)), covariance_dim=16, beam_size=16,
              image_size=448, patch_size=128, patch_config="translation")
    return SaccadicViTConfig(**{**kw, **overrides})


def objective(trained: nn.Module, hidden: torch.Tensor,
              context: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of `trained` (a module with `pattern` and
    `refiner`): the match NLL plus the refiner's preservation error."""
    nll = pattern_nll_loss(trained.pattern, hidden, context)
    pres, aux = refiner_preservation_loss(trained.pattern, trained.refiner, hidden, context)
    return nll + pres, {"nll": nll.detach(), "preservation": pres.detach(),
                        **{k: v.detach() for k, v in aux.items()}}


def main(argv: Optional[List[str]] = None,
         config: Optional[SaccadicViTConfig] = None) -> dict:
    """Collect the pools and train; returns the per-step losses and the
    pools' sizes.  `config` replaces the training config (the tests pass a
    tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--glimpses", type=int, default=8)
    ap.add_argument("--context", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dataset", default=None,
                    help="a local image folder (or a dataset id for datasets.load_dataset)")
    ap.add_argument("--seed", type=int, default=1212)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config or train_config()
    gen = torch.Generator().manual_seed(args.seed)
    if args.dataset:
        pix = dataset_batch(args.dataset, args.batch, cfg.image_size, dev)[0]
    else:
        pix = torch.randn((args.batch, cfg.image_size, cfg.image_size, 3), generator=gen).to(dev)
    embeddings = SaccadicViTEmbeddings(cfg, gen).to(dev)
    trained = nn.Module()
    trained.pattern = SaccadicViTMultiStatePattern(cfg, gen)
    trained.refiner = TransformerSaccadicViTPredictor(cfg, gen)
    trained.to(dev)

    # the glimpse pools, from the batched controller (not differentiated)
    trace = batched_saccade_run(embeddings, trained.pattern, pix, num_steps=args.glimpses)
    pool = trace["embeddings"].transpose(0, 1)  # [B, T, D]
    context, hidden = pool[:, :args.context], pool[:, args.context:]
    n_sacc = int(trace["num_saccades"].sum())
    print(f"collected pools: hidden {tuple(hidden.shape)}, context {tuple(context.shape)}, "
          f"{n_sacc} completed saccades", flush=True)

    optimizer = make_optimizer(args.lr, weight_decay=1e-4)  # optax.adamw(lr)
    step = train_step_fn(lambda m, batch, g: objective(m, *batch), optimizer)
    state = optimizer.init(trained)
    losses: List[float] = []
    for i in range(args.steps):
        loss, parts = step(trained, state, (hidden, context), None)
        losses.append(float(loss))
        print(f"step {i:3d}  loss {losses[-1]:10.4f}  nll {float(parts['nll']):10.4f}  "
              f"preservation {float(parts['preservation']):10.4f}", flush=True)
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'down' if losses[-1] < losses[0] else 'UP'})", flush=True)
    return {"losses": losses, "hidden": tuple(hidden.shape), "context": tuple(context.shape),
            "num_saccades": n_sacc, "device": str(dev)}


if __name__ == "__main__":
    main()
