"""The JPEG-corpus route on a card's machine: the native libjpeg decoder's
link and speed, and short runs of the three entry points that write and
decode a JPEG corpus (`pretrain_synthetic`, `train_predictive_synthetic`,
`train_subsample_synthetic`) at their default configurations.

    python tools/jpeg_card_check.py [--steps 20] [--out DIR]

Prints the card's name and power limit, which libjpeg the decoder links
(`native.link_args`), the decoder's images per second (all host threads;
the median of 5 batches of 256), each entry point's losses, and one JSON
line.  Steps and corpus sizes are cut (`--steps`; 256 images, 128 held
out); everything else is the entry points' defaults, except that no figure
is drawn (the machine has no matplotlib).  Fails without a card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _blobs(n: int, h: int = 375, w: int = 500) -> list:
    """q95 JPEGs of smooth random images (upsampled noise)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(buf, format="JPEG",
                                                                     quality=95)
        out.append(buf.getvalue())
    return out


def decoder_rate(size: int = 224) -> dict:
    """img/s of `decode_resize_u8` and `decode_preprocess_batch` on 256
    500 x 375 JPEGs to `size` px (DCT-scaled by 1/2)."""
    from msvit_tpu_torch import native

    blobs = _blobs(256)
    res = {}
    for name, fn in (("decode_resize_u8", lambda: native.decode_resize_u8(blobs, size)),
                     ("decode_preprocess_batch", lambda: native.decode_preprocess_batch(
                         blobs, size, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)))):
        fn()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            _, ok = fn()
            times.append(time.perf_counter() - t0)
            assert ok.all(), name
        res[name] = len(blobs) / statistics.median(times)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("jpeg_card_check: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from msvit_tpu_torch import native
    from msvit_tpu_torch.examples import (
        pretrain_synthetic, train_predictive_synthetic, train_subsample_synthetic)

    t0 = time.perf_counter()
    lib = native.build("decode")
    res = {"card": smi, "link": native.link_args("decode"), "build_s": time.perf_counter() - t0,
           "library": os.path.basename(lib), "cpu_threads": os.cpu_count(),
           "decoder_img_per_s": decoder_rate()}
    print(f"[jpeg] decoder links {res['link']}, built in {res['build_s']:.1f} s; img/s "
          f"{res['decoder_img_per_s']} ({smi})", flush=True)
    n, k = str(args.steps), str(max(1, args.steps // 2))
    with tempfile.TemporaryDirectory(prefix="jpeg_card_") as tmp:
        out = args.out or tmp
        runs = {
            "pretrain_synthetic": lambda: pretrain_synthetic.main(
                ["--steps", n, "--corpus-size", "256", "--eval-size", "128",
                 "--out", out]),
            "train_predictive_synthetic": lambda: train_predictive_synthetic.main(
                ["--steps", n, "--corpus-size", "256", "--out", out, "--viz-at", "",
                 "--log-every", "5"]),
            "train_subsample_synthetic": lambda: train_subsample_synthetic.main(
                ["--warmup", k, "--steps", k, "--corpus-size", "256", "--eval-size", "128",
                 "--out", out, "--no-figure", "--log-every", "5"]),
        }
        for name, run in runs.items():
            calls = native.decode_resize_u8.calls
            t0 = time.perf_counter()
            summary = run()
            res[name] = {
                "seconds": time.perf_counter() - t0, "device": summary.get("device"),
                "native_decodes": native.decode_resize_u8.calls - calls,
                **{key: summary[key] for key in ("final_loss", "holdout_top1", "first", "last",
                                                   "acc_learned", "acc_never", "acc_always")
                   if key in summary}}
            if "history" in summary:
                res[name]["losses"] = [h.get("loss", h.get("total", h.get("ce")))
                                     for h in summary["history"]]
            print(f"[jpeg] {name}: {res[name]}", flush=True)
    print(json.dumps(res, default=float), flush=True)
    return res


if __name__ == "__main__":
    main()
