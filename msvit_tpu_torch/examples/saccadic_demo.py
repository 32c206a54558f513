"""Saccadic demo (counterpart of `examples/saccadic_demo.py`): the glimpse
tokenizer, the pattern beam matcher on random features, and the full serial
saccade controller, at the demo's config (768 wide, a 4-layer refiner,
patterns of complexity 1 and 2, 64 each, rank 64, beam 64, 448 px, 128-px
glimpses) with seeded random weights.

    python -m msvit_tpu_torch.examples.saccadic_demo
    python -m msvit_tpu_torch.examples.saccadic_demo --device cpu

The run is on the CUDA card; ``--device cpu`` is the only way to the CPU
(with no card and no ``--device cpu`` it raises).  The image and the
random features are drawn on the CPU from ``--seed``, then moved.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.saccadic import SaccadicViTConfig, SaccadicViTModel


def demo_config(**overrides) -> SaccadicViTConfig:
    kw = dict(hidden_size=768, num_hidden_layers=4, num_attention_heads=12,
              num_patterns=((1, 64), (2, 64)), covariance_dim=64, beam_size=64,
              image_size=448, patch_size=128, patch_config="translation")
    return SaccadicViTConfig(**{**kw, **overrides})


def main(argv: Optional[List[str]] = None,
         config: Optional[SaccadicViTConfig] = None) -> dict:
    """Run the three parts; returns what they printed, as a dict.  `config`
    replaces the demo config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1212)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config or demo_config()
    gen = torch.Generator().manual_seed(args.seed)
    size, d = cfg.image_size, cfg.hidden_size
    pix = torch.randn((1, size, size, 3), generator=gen).to(dev)
    model = SaccadicViTModel(cfg, generator=gen, device=dev).eval()

    with torch.no_grad():
        # 1. the glimpse tokenizer
        e = model.embeddings(pix, torch.zeros(1, cfg.dof, device=dev))
        print("glimpse embedding:", tuple(e.shape), flush=True)
        # 2. the pattern matcher on random features
        h = torch.randn((1, 4, d), generator=gen).to(dev)
        c = torch.randn((1, 6, d), generator=gen).to(dev)
        best = {}
        for (k, n_wild), p in model.pattern.match(h, c, 1).items():
            best[(k, n_wild)] = float(p["joint_log_pdf"][0, 0])
            print(f"complexity {k}, wildcards {n_wild}: beam {p['pattern_index'].shape[1]}, "
                  f"best joint log-pdf {best[(k, n_wild)]:.2f}", flush=True)
    # 3. the serial saccade controller
    out = model(pix, max_trace_length=8, max_saccade_length=4)
    print("controller steps:", out["num_steps"])
    print("trace queries:", out["trace"]["query"].shape)
    print("terminal indices:", out["terminal_indices"])
    print("constructed edges:", len(out["constructed_edges"]), flush=True)
    return {"embedding_shape": tuple(e.shape), "best_joint_log_pdf": best,
            "num_steps": out["num_steps"], "terminal_indices": out["terminal_indices"],
            "constructed_edges": len(out["constructed_edges"]), "device": str(dev)}


if __name__ == "__main__":
    main()
