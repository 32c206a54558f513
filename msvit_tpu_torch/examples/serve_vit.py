"""Serving demo (counterpart of `examples/serve_vit.py`): Poisson request
arrivals at ``--rps`` into `BatchingServer` (power-of-two buckets, deadline
coalescing, two batches in flight) in front of the ViT-B/16 encoder, int8
or bf16; it reports p50/p95/p99, the mean batch and the sustained rate.

    python -m msvit_tpu_torch.examples.serve_vit --mode bf16 --rps 200 --seconds 5
    python -m msvit_tpu_torch.examples.serve_vit --mode int8

Wire format: requests are uint8 HWC images (a quarter of an f32 image's
bytes), normalized on the device (``/ 127.5 - 1``); responses are the CLS
embedding (f32), not the token grid.  int8 mode runs the calibrated int8
forward (K3 in every layer; scales calibrated on 64 seeded images) and, by
default, routes buckets of at most ``--small-bucket-max`` (2) to the bf16
forward (K1), as the JAX example does.  Seeded random weights.  It runs on
the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
from msvit_tpu_torch.models.base.quantized import (
    calibrate_act_scales, quantize_vit_params, quantized_vit_apply)
from msvit_tpu_torch.serve import BatchingServer


def build_apply(mode: str, cfg: BaseViTConfig, dev: torch.device) -> Callable:
    """uint8 [B, S, S, 3] numpy -> CLS embedding [B, D] f32 on the device,
    bf16 or int8 (calibrated)."""
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    s = cfg.image_size

    def normalize(u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0

    if mode == "int8":
        qparams = quantize_vit_params(model)
        calib = torch.randn(64, s, s, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        scales = calibrate_act_scales(qparams, cfg, calib)

        def int8_fwd(u8):
            with torch.inference_mode():
                feats = quantized_vit_apply(qparams, cfg, normalize(u8), act_scales=scales)
                return feats[:, 0].float()

        return int8_fwd

    def bf16_fwd(u8):
        with torch.inference_mode():
            return model(normalize(u8))["last_hidden_state"][:, 0].float()

    return bf16_fwd


def main(argv: Optional[List[str]] = None,
         config: Optional[BaseViTConfig] = None) -> dict:
    """Serve for ``--seconds``; returns the server's stats and the wall
    time.  `config` replaces ViT-B/16 @224 (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--rps", type=float, default=200.0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--small-bucket-max", type=int, default=2,
                    help="int8 mode routes buckets <= this to the bf16 forward; 0 disables it")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config or BaseViTConfig()
    s = cfg.image_size

    apply_fn = build_apply(args.mode, cfg, dev)
    small_fn = (build_apply("bf16", cfg, dev)
                if args.mode == "int8" and args.small_bucket_max > 0 else None)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (32, s, s, 3), dtype=np.uint8)

    with BatchingServer(apply_fn, images[0], max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms, small_apply_fn=small_fn,
                        small_bucket_max=args.small_bucket_max if small_fn else 0) as srv:
        print(f"warming up {len(srv.buckets)} buckets {srv.buckets} ...", flush=True)
        t0 = time.perf_counter()
        srv.warmup()
        print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

        futs, lock = [], threading.Lock()
        stop = time.monotonic() + args.seconds

        def client():
            i = 0
            while time.monotonic() < stop:
                f = srv.submit(images[i % len(images)])
                with lock:
                    futs.append(f)
                i += 1
                time.sleep(rng.exponential(1.0 / args.rps))

        th = threading.Thread(target=client)
        t0 = time.perf_counter()
        th.start()
        th.join()
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.stats()

    print(f"{args.mode}: {stats['requests']} requests in {wall:.1f}s "
          f"({stats['requests'] / wall:.0f} img/s sustained, {dev})\n"
          f"  latency p50/p95/p99: {stats['p50_ms']:.1f} / {stats['p95_ms']:.1f} / "
          f"{stats['p99_ms']:.1f} ms\n"
          f"  batches: {stats['batches']}, mean batch {stats['mean_batch']:.1f}", flush=True)
    return {"stats": stats, "wall_s": wall, "dim": int(outs[0].shape[-1]),
            "finite": all(bool(torch.isfinite(o).all()) for o in outs)}


if __name__ == "__main__":
    main()
