"""Subsample REINFORCE on the procedural corpus (counterpart of
`examples/train_subsample_synthetic.py`): a 6-layer trunk, grid 4 -> x2,
depth 1, bs32, whose region masks make the policy measurable (a box is
"object-relevant" if at least ``--obj-thresh`` of its pixels belong to a
foreground object; the metric is the precision and recall of the root
subdivision decisions against that).

    python -m msvit_tpu_torch.examples.train_subsample_synthetic                    # full
    python -m msvit_tpu_torch.examples.train_subsample_synthetic --warmup 8 --steps 8
    python -m msvit_tpu_torch.examples.train_subsample_synthetic --device cpu --warmup 2 --steps 2

Phases:
  A. supervised warmup of trunk and head under the sampled (at first
     near-random) policy, AdamW(``--warmup-lr``) on every parameter but the
     policy (the classifier only with ``--trunk s8d6`` unless
     ``--warm-full``);
  B. REINFORCE on the policy only, AdamW(``--lr``): the batch-standardised
     cost (CE, plus ``--token-cost`` times the share of the capacity in
     use) times the episode's log-probability (`reinforce_loss`).

Evaluation: held-out accuracy of the learned policy against never- and
always-subdivide controls (the same weights with the policy bias forced to
-20 and +20), with the tokens each keeps, and the quadtree heat-map figure
of four held-out scenes (`viz.visualize_subsample_output`, `quadtree.png`;
matplotlib needed, ``--no-figure`` for none).

The same flags and defaults as the JAX example, plus ``--device``: the run
is on the CUDA card; ``--device cpu`` is the only way to the CPU (with no
card and no ``--device cpu`` it raises), and ``--no-figure``.  Step i of phase A is seeded with
`fold_in(seed, i)`, step i of phase B with `fold_in(seed, 10**6 + i)`; the
step's policy `Rng` is a draw from that generator.  Outputs under
``--out/subsample[_<label mode>]``: `metrics.jsonl`, `summary.json` and
`quadtree.png`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from msvit_tpu_torch.compat.family import transfer_base_to_subsample
from msvit_tpu_torch.data.synthetic import (
    corpus_batches, ensure_corpus, generate_batch, label_classes)
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.subsample import (
    SubsampleViTConfig, SubsampleViTForImageClassification, reinforce_loss)
from msvit_tpu_torch.train import make_optimizer, restore_checkpoint, train_step_fn
from msvit_tpu_torch.utils.metrics import MetricsLogger
from msvit_tpu_torch.utils.rng import Rng, draw_seed, fold_in


def box_object_fraction(regions: np.ndarray, grid: int,
                        target_only: bool = False) -> np.ndarray:
    """[B, G*G] share of object pixels per root box (row-major (y, x), the
    model's initial grid).  With `target_only` only the label-defining
    target object counts (drawn last: the image's largest region id)."""
    b, s, _ = regions.shape
    cell = s // grid
    r = regions[:, : cell * grid, : cell * grid].reshape(b, grid, cell, grid, cell)
    if target_only:
        tid = regions.reshape(b, -1).max(axis=1)
        occ = r == tid[:, None, None, None, None]
    else:
        occ = r > 0
    return occ.mean(axis=(2, 4)).reshape(b, grid * grid)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Subsample REINFORCE on the procedural corpus.")
    ap.add_argument("--warmup", type=int, default=600, help="phase A steps")
    ap.add_argument("--steps", type=int, default=400, help="phase B steps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--warmup-lr", type=float, default=3e-4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--corpus-size", type=int, default=2048)
    ap.add_argument("--eval-size", type=int, default=512)
    ap.add_argument("--obj-thresh", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/synthetic")
    ap.add_argument("--label-mode", default="largest",
                    choices=["largest", "center", "texture", "ltexture"],
                    help="'center': the label is the centered target object's class")
    ap.add_argument("--max-objects", type=int, default=3)
    ap.add_argument("--trunk", default="none", choices=["none", "s8d6"],
                    help="'s8d6': start the trunk from the pretrain_synthetic s8d6 "
                    "checkpoint; phase A then trains the head only, phase B the policy")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--token-cost", type=float, default=0.0,
                    help="cost per sample = CE + this x tokens / capacity (0: pure CE)")
    ap.add_argument("--warm-full", action="store_true",
                    help="phase A fine-tunes the whole trunk, not the head only")
    ap.add_argument("--log-every", type=int, default=25, help="phase B log period")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--figure", action=argparse.BooleanOptionalAction, default=True,
                    help="draw the quadtree heat map (needs matplotlib)")
    return ap


def _suffix(args) -> str:
    sfx = "" if args.label_mode == "largest" else f"_{args.label_mode}"
    return sfx + (f"_m{args.max_objects}" if args.max_objects != 3 else "")


def model_config(args) -> SubsampleViTConfig:
    """The reference training script's geometry: 6 layers, 224 px, grid
    4 -> x2, depth 1, open mode; patch 16 from scratch, the s8d6 trunk's
    (384 wide, 6 heads, patch 8) with ``--trunk s8d6``."""
    trunk = dict(patch_size=16)
    if args.trunk == "s8d6":
        trunk = dict(hidden_size=384, num_attention_heads=6, patch_size=8)
    return SubsampleViTConfig(
        num_hidden_layers=6, image_size=224, initial_grid_size=4,
        multiplicative_grid_size=2, nesting_mode="open", max_depth=1,
        num_labels=len(label_classes(args.label_mode)), **trunk)


def _set_trainable(model, trainable) -> None:
    for n, p in model.named_parameters():
        p.requires_grad_(trainable(tuple(n.split("."))))


def train(args, data: Dict[str, np.ndarray],
          config: Optional[SubsampleViTConfig] = None) -> dict:
    """Both phases and the evaluation on the loaded corpus `data`; writes
    `metrics.jsonl` and `summary.json` and returns the summary (with the
    logged rows under "history").  `config` replaces `model_config`'s
    (the tests pass a tiny one)."""
    dev = resolve_device(args.device)
    run_dir = os.path.join(args.out, f"subsample{_suffix(args)}")
    os.makedirs(run_dir, exist_ok=True)
    cfg = config or model_config(args)
    model = SubsampleViTForImageClassification(
        cfg, generator=torch.Generator().manual_seed(args.seed), device=dev).train()
    if args.trunk == "s8d6":
        ckpt = args.ckpt or os.path.join(args.out, f"pretrain_s8d6{_suffix(args)}", "ckpt")
        params = restore_checkpoint(ckpt)["params"]
        base = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
        model.load_state_dict(transfer_base_to_subsample(
            base, model.state_dict(), cfg.num_hidden_layers))
        print(f"bootstrapped trunk from {ckpt}", flush=True)
    n_roots = cfg.num_roots
    host = corpus_batches(data, args.batch, seed=args.seed, include_regions=True, uint8=True)

    def nxt():
        batch = next(host)
        pix = torch.from_numpy(batch["pixel_values"]).to(dev).float() / 127.5 - 1.0
        return pix, torch.from_numpy(batch["labels"]).long().to(dev), batch["regions"]

    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), echo=False)
    history: List[Dict[str, float]] = []

    # ---- phase A: supervised warmup (the policy frozen, its decisions sampled)
    if args.trunk == "s8d6" and not args.warm_full:
        warm_trainable = lambda path: "classifier" in path  # noqa: E731
    else:
        warm_trainable = lambda path: "projection" not in path  # noqa: E731
    _set_trainable(model, warm_trainable)

    def warm_loss(model, batch, generator):
        pix, labels = batch
        out = model(pix, labels, rng=Rng(draw_seed(generator)))
        return out["loss"].mean(), None

    warm_opt = make_optimizer(args.warmup_lr, trainable=warm_trainable)
    step, state = train_step_fn(warm_loss, warm_opt), warm_opt.init(model)
    t0 = time.perf_counter()
    for i in range(args.warmup):
        pix, labels, _ = nxt()
        loss, _ = step(model, state, (pix, labels),
                       torch.Generator().manual_seed(fold_in(args.seed, i)))
        if i % 50 == 0 or i == args.warmup - 1:
            row = {"phase": "warmup", "ce": float(loss)}
            metrics.log(i, **row)
            history.append({"step": i, **row})
            print(f"[warmup {i}] CE {row['ce']:.4f}", flush=True)
    print(f"phase A done in {time.perf_counter() - t0:.0f}s", flush=True)

    # ---- phase B: REINFORCE on the policy only
    def pol_trainable(path):
        return "projection" in path

    _set_trainable(model, pol_trainable)

    def pol_loss(model, batch, generator):
        pix, labels = batch
        out = model(pix, labels, rng=Rng(draw_seed(generator)), output_logs=True)
        cost = out["loss"]
        if args.token_cost > 0.0:
            cost = cost + args.token_cost * out["last_valid_mask"].sum(-1) / float(cfg.capacity)
        decisions = out["logs"]["subsample_masks"][0][:, :n_roots]
        return reinforce_loss(cost, out["log_prob"]), {
            "ce": out["loss"].detach().mean(), "decisions": decisions}

    pol_opt = make_optimizer(args.lr, trainable=pol_trainable)
    step, state = train_step_fn(pol_loss, pol_opt), pol_opt.init(model)
    target_only = args.label_mode in ("center", "texture")
    t0 = time.perf_counter()
    for i in range(args.steps):
        pix, labels, regions = nxt()
        loss, aux = step(model, state, (pix, labels),
                         torch.Generator().manual_seed(fold_in(args.seed, 10**6 + i)))
        if i % args.log_every == 0 or i == args.steps - 1:
            relevant = box_object_fraction(regions, cfg.initial_grid_size,
                                           target_only) >= args.obj_thresh
            dec = aux["decisions"].cpu().numpy()
            tp = (dec & relevant).sum()
            row = {"phase": "reinforce", "reinforce": float(loss), "ce": float(aux["ce"]),
                   "precision": float(tp / max(dec.sum(), 1)),
                   "recall": float(tp / max(relevant.sum(), 1)),
                   "subdiv_rate": float(dec.mean()), "relevant_rate": float(relevant.mean())}
            metrics.log(args.warmup + i, **row)
            history.append({"step": args.warmup + i, **row})
            print(f"[reinforce {i}] CE {row['ce']:.4f}  subdiv {row['subdiv_rate']:.2f}  "
                  f"precision {row['precision']:.3f} (base {row['relevant_rate']:.3f})  "
                  f"recall {row['recall']:.3f}", flush=True)
    print(f"phase B done in {time.perf_counter() - t0:.0f}s", flush=True)
    metrics.close()
    _set_trainable(model, lambda path: True)

    # ---- evaluation: the learned policy against forced controls
    hold = generate_batch(range(20_000_000, 20_000_000 + args.eval_size),
                          size=cfg.image_size, label_mode=args.label_mode,
                          max_objects=args.max_objects)
    bias = model.model.projection.bias

    @torch.no_grad()
    def accuracy(forced: Optional[float]):
        saved = bias.detach().clone()
        if forced is not None:
            bias.data.fill_(forced)
        correct = tokens = 0.0
        starts = range(0, args.eval_size - args.batch + 1, args.batch)
        model.eval()
        for lo in starts:
            pix = torch.from_numpy(hold["images"][lo: lo + args.batch]).to(dev).float()
            out = model(pix / 127.5 - 1.0, rng=Rng(lo))
            pred = out["classifier_logits"].argmax(-1).cpu().numpy()
            correct += float((pred == hold["labels"][lo: lo + args.batch]).sum())
            tokens += float(out["last_valid_mask"].sum(-1).float().mean())
        model.train()
        bias.data.copy_(saved)
        return correct / (len(starts) * args.batch), tokens / len(starts)

    acc_learned, tok_learned = accuracy(None)
    acc_never, tok_never = accuracy(-20.0)
    acc_always, tok_always = accuracy(20.0)
    print(f"\nheld-out top-1 (n={args.eval_size}, chance "
          f"{1.0 / cfg.num_labels:.3f}):")
    print(f"  learned policy : {acc_learned:.4f}  ({tok_learned:.1f} tokens/img)")
    print(f"  never subdivide: {acc_never:.4f}  ({tok_never:.1f} tokens/img)")
    print(f"  always subdivide:{acc_always:.4f}  ({tok_always:.1f} tokens/img)", flush=True)
    summary = {"warmup": args.warmup, "steps": args.steps, "label_mode": args.label_mode,
               "device": str(dev), "acc_learned": acc_learned, "acc_never": acc_never,
               "acc_always": acc_always, "tokens_learned": tok_learned,
               "tokens_never": tok_never, "tokens_always": tok_always}
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if args.figure:  # the quadtree heat map of four held-out scenes
        from msvit_tpu_torch.viz import visualize_subsample_output

        pix = torch.from_numpy(hold["images"][:4]).to(dev).float() / 127.5 - 1.0
        model.eval()
        with torch.no_grad():
            out = model(pix, rng=Rng(0), output_logs=True, return_pixel_values=True)
        visualize_subsample_output(out, model.model.tree, show=False,
                                   save_path=os.path.join(run_dir, "quadtree.png"))
    print(f"metrics under {run_dir}", flush=True)
    return {**summary, "history": history}


def main(argv: Optional[List[str]] = None,
         config: Optional[SubsampleViTConfig] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raise before the corpus is written
    size = (config or model_config(args)).image_size
    data = ensure_corpus(args.out, args.corpus_size, size=size, seed=args.seed,
                         label_mode=args.label_mode, max_objects=args.max_objects)
    return train(args, data, config)


if __name__ == "__main__":
    main()
