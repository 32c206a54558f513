"""Predictive training on the procedural corpus (counterpart of
`examples/train_predictive_synthetic.py`): the predictive encoder at the
reference sandbox's config (ViT-B trunk, 768 wide, 12 layers, bs64, 224 px,
64-px scaling glimpses, at most 6 contexts, no CLS), trained from scratch
by AdamW at optax's `adamw(2e-3)` defaults (weight decay 1e-4).

    python -m msvit_tpu_torch.examples.train_predictive_synthetic                # 1000 steps
    python -m msvit_tpu_torch.examples.train_predictive_synthetic --steps 40 --losses all7
    python -m msvit_tpu_torch.examples.train_predictive_synthetic --device cpu --steps 2

The same flags and defaults as the JAX example, plus ``--device``: the run
is on the CUDA card; ``--device cpu`` is the only way to the CPU (with no
card and no ``--device cpu`` it raises).  ``--losses sandbox`` weighs
{context_patch 1e-4, query_patch 1.0, positional_regularization 0.5};
``all7`` turns on every loss (unit weights elsewhere) with
`normalize_latent`.  ``--viz-at`` (default "0,mid,end", as JAX's) draws
`viz.visualize_predictive_sample` of the first batch's first images at
those steps (`sample_step<i>.png`; matplotlib needed, ``--viz-at ""`` for
none).

`main` writes the JPEG corpus once (`ensure_corpus`, PIL) and loads it;
`train(args, data)` takes a loaded corpus, so a caller can hand it one made
in memory by `generate_batch`.  Step i's generator is seeded with
`fold_in(seed, i)`, and the step's glimpse `Rng` with a draw from it.
Outputs under ``--out/predictive_<losses>``: `metrics.jsonl` (each loss
every ``--log-every`` steps) and `summary.json` (first and last windowed
means per loss, the predict-the-mean bars of the patch losses on four
fresh batches).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from msvit_tpu_torch.data.synthetic import corpus_batches, ensure_corpus
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.predictive import (
    PredictiveViTConfig, PredictiveViTModel, PredictiveViTTrainingConfig,
    patch_mean_bar, training_loss)
from msvit_tpu_torch.train import make_optimizer, train_step_fn
from msvit_tpu_torch.utils.metrics import MetricsLogger
from msvit_tpu_torch.utils.rng import Rng, draw_seed, fold_in

SEED = 1212


def sandbox_config(**overrides) -> PredictiveViTConfig:
    """The reference sandbox's geometry (the bench's predictive config)."""
    kw = dict(use_cls_token=False, patch_config="scaling", default_patch_scale=0.4,
              patch_config_scale=((1.0, 0.0), (1.0, 0.0), (1.0, -1.0)), patch_size=64,
              expected_context_length=2.0, max_context_length=6)
    return PredictiveViTConfig(**{**kw, **overrides})


def training_config(losses: str) -> PredictiveViTTrainingConfig:
    if losses == "all7":
        return PredictiveViTTrainingConfig(
            preservation=1.0, context_prediction=1.0, query_prediction=1.0,
            context_patch_prediction=1e-4, query_patch_prediction=1.0,
            positional_recovery=1.0, positional_regularization=0.5,
            normalize_latent=True)
    return PredictiveViTTrainingConfig(context_patch_prediction=1e-4,
                                       query_patch_prediction=1.0,
                                       positional_regularization=0.5)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--corpus-size", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/synthetic")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--viz-at", default="0,mid,end",
                    help="steps that draw a figure: 0, mid, end (\"\" for none)")
    ap.add_argument("--losses", default="sandbox", choices=["sandbox", "all7"],
                    help="'sandbox': query_patch 1.0, context_patch 1e-4, "
                    "pos_reg 0.5; 'all7': every loss, normalize_latent=True")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def build(args, config: Optional[PredictiveViTConfig] = None):
    """(model, loss weights, the train step, its optimizer state) on
    ``args.device``: the model drawn from `SEED` (the sandbox config
    unless `config`), AdamW at optax's `adamw(args.lr)` defaults.  The step
    is ``step(model, state, pixels, generator) -> (mean error, per-loss
    means)``."""
    dev = resolve_device(args.device)
    tc = training_config(args.losses)
    model = PredictiveViTModel(config or sandbox_config(),
                               generator=torch.Generator().manual_seed(SEED),
                               device=dev).train()

    def loss_fn(model, pix, generator):
        out = model(pix, rng=Rng(draw_seed(generator)), output_inputs=True)
        err, losses, _ = training_loss(model, pix, out, tc)
        return err.mean(), {k: v.detach().mean() for k, v in losses.items()}

    optimizer = make_optimizer(args.lr, weight_decay=1e-4)  # optax.adamw(lr)
    return model, tc, train_step_fn(loss_fn, optimizer), optimizer.init(model)


def train(args, data: Dict[str, np.ndarray],
          config: Optional[PredictiveViTConfig] = None) -> dict:
    """Train on the loaded corpus `data` ({"images" [N, S, S, 3] uint8,
    ...}); writes `metrics.jsonl` and `summary.json` and returns the
    summary (with "history", the logged rows).  `config` replaces the
    sandbox config (the tests pass a tiny one)."""
    dev = resolve_device(args.device)
    run_dir = os.path.join(args.out, f"predictive_{args.losses}")
    os.makedirs(run_dir, exist_ok=True)
    model, tc, step, opt_state = build(args, config)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    print(f"predictive model: {n_params / 1e6:.1f}M params, bs{args.batch}, "
          f"{args.steps} steps, losses {args.losses}", flush=True)
    host = corpus_batches(data, args.batch, seed=args.seed, uint8=True)

    def nxt() -> torch.Tensor:
        pix = torch.from_numpy(next(host)["pixel_values"]).to(dev)
        return pix.float() / 127.5 - 1.0

    pix0 = nxt()

    def render(step_no: int) -> None:
        """`visualize_predictive_sample` of the first batch at the current
        weights."""
        from msvit_tpu_torch.viz import visualize_predictive_sample

        with torch.no_grad():
            out = model(pix0[:4], rng=Rng(777), output_inputs=True)
            _, _, meta = training_loss(model, pix0[:4], out, tc)
        visualize_predictive_sample(pix0[:4], out, meta, model, num_ims=3, show=False,
                                    save_path=os.path.join(run_dir, f"sample_step{step_no}.png"))

    marks = {"0": 0, "mid": args.steps // 2, "end": args.steps - 1}
    viz_steps = {marks.get(m, -1) for m in args.viz_at.split(",")}

    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), echo=False)
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        gen = torch.Generator().manual_seed(fold_in(args.seed, i))
        loss, losses = step(model, opt_state, pix0 if i == 0 else nxt(), gen)
        if i in viz_steps:
            render(i)
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: float(v) for k, v in losses.items()}
            row["total"] = float(loss)
            history.append(row)
            metrics.log(i, **row)
            print(f"iter {i}: " + "  ".join(f"{k}={v:.4f}" for k, v in row.items()),
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    metrics.close()

    # the predict-the-mean bars at the final weights, over four fresh batches
    bars: Dict[str, float] = {}
    with torch.no_grad():
        for j in range(4):
            pix = nxt()
            out = model(pix, rng=Rng(10_000 + j), output_inputs=True)
            _, losses, meta = training_loss(model, pix, out, tc)
            b = patch_mean_bar(out, meta, cfg)
            for k in ("query_patch", "context_patch"):
                b[f"{k}_actual"] = losses[f"{k}_prediction"].mean()
            for k, v in b.items():
                bars[k] = bars.get(k, 0.0) + float(v) / 4
    print(f"predict-the-mean bar: query_patch {bars['query_patch_actual']:.4f} vs bar "
          f"{bars['query_patch_mean_bar']:.4f}  |  context_patch "
          f"{bars['context_patch_actual']:.4f} vs bar {bars['context_patch_mean_bar']:.4f}",
          flush=True)

    # learning evidence: the first window's mean against the last's
    k = max(1, min(4, len(history) // 4))
    first = {key: float(np.mean([h[key] for h in history[:k]])) for key in history[0]}
    last = {key: float(np.mean([h[key] for h in history[-k:]])) for key in history[0]}
    for key in first:
        print(f"{key:26s} {first[key]:12.4f} {last[key]:12.4f} "
              f"{last[key] / (abs(first[key]) + 1e-12):8.3f}", flush=True)
    summary = {"steps": args.steps, "batch": args.batch, "device": str(dev),
               "train_sec": dt, "first": first, "last": last, "mean_bars": bars,
               "history": history}
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps * args.batch / dt:.1f} img/s, "
          f"the first step's warm-up included); metrics under {run_dir}", flush=True)
    return summary


def main(argv: Optional[List[str]] = None,
         config: Optional[PredictiveViTConfig] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raise before the corpus is written
    size = (config or sandbox_config()).image_size
    data = ensure_corpus(args.out, args.corpus_size, size=size, seed=args.seed)
    return train(args, data, config)


if __name__ == "__main__":
    main()
