"""Export -> reload -> serve (counterpart of `examples/export_serving.py`):
the deployment workflow.  The ViT forward (CLS embedding) is exported with
a polymorphic batch to an artifact on disk (`msvit_tpu_torch.export`),
reloaded with no model code (the graph calls K1, the registered op), checked
against the live model, and driven behind the micro-batching server.

    python -m msvit_tpu_torch.examples.export_serving [--requests 64]
    python -m msvit_tpu_torch.examples.export_serving --device cpu --hidden 64 --layers 1 --heads 2

ViT-B/16 @224 by default (the JAX example's default is a 192-wide, 4-layer
trunk); seeded random weights; f32 requests of 224 x 224 x 3.  It runs on
the CUDA card; ``--device cpu`` is the only way to the CPU (with no card and
no ``--device cpu`` it raises).  On the card the reloaded graph runs the
same kernels on the same inputs as the live model, so the two are equal
element for element.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.export import export_forward, load_forward
from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
from msvit_tpu_torch.serve import BatchingServer


def main(argv: Optional[List[str]] = None) -> dict:
    """Export, reload, check and serve; returns the artifact's size, the
    reloaded-vs-live difference and the server's stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = BaseViTConfig(hidden_size=args.hidden, num_hidden_layers=args.layers,
                        num_attention_heads=args.heads, image_size=224, patch_size=16)
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    pix = torch.randn(8, 224, 224, 3, generator=torch.Generator().manual_seed(0)).to(dev)

    def fwd(p, x):
        out = torch.func.functional_call(model, p, (x,))["last_hidden_state"]
        return out[:, 0].float()  # CLS embedding

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "vit.msvx")
        art = export_forward(fwd, (params, pix), polymorphic_batch=True)
        with open(path, "wb") as f:
            f.write(art)
        print(f"exported artifact: {len(art) / 1e6:.2f} MB -> {path}", flush=True)
        with open(path, "rb") as f:
            g = load_forward(f.read())

    with torch.no_grad():
        want = fwd(params, pix)
    got = g(params, pix)
    diff = float((got - want).abs().max())
    print(f"reloaded artifact vs live model: max abs diff {diff!r}", flush=True)

    def apply(x: np.ndarray):
        return g(params, torch.from_numpy(x).to(dev))

    rng = np.random.default_rng(0)
    with BatchingServer(apply, example=np.zeros((224, 224, 3), np.float32),
                        max_batch=args.max_batch) as server:
        server.warmup()
        futs = [server.submit(rng.standard_normal((224, 224, 3)).astype(np.float32))
                for _ in range(args.requests)]
        outs = [f.result(timeout=600) for f in futs]
        stats = server.stats()
    print(f"served {len(outs)} requests, embedding dim {outs[0].shape[-1]}; latency p50 "
          f"{stats['p50_ms']:.1f} ms p95 {stats['p95_ms']:.1f} ms ({dev})", flush=True)
    return {"artifact_bytes": len(art), "max_abs_diff": diff, "stats": stats,
            "dim": int(outs[0].shape[-1])}


if __name__ == "__main__":
    main()
