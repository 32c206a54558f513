"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (`msvit_tpu_torch`, never JAX) through its main path and
fails (non-zero exit, no result line) if any phase fails:

1. device: a CUDA card is required, there is no CPU fallback; prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the hand-written kernels from `msvit_tpu_torch/csrc`;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (max abs error against a stated tolerance), then
   both timed with CUDA events in turns (plain, kernel, kernel, plain);
4. the slice: ViT-B/16 @224 with seeded random weights, int8-quantized and
   calibrated, served by `BatchingServer` (int8 buckets > 2, bf16 buckets
   of 1 and 2, uint8 requests, CLS features out); checks every response,
   bf16 against the plain attention path, int8 against bf16, and that both
   kernels were launched by the served requests.

The second-to-last line is a JSON object with each kernel's launches in the
served run, its error and its time beside the plain version's; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
K3_BF16_REL_TOL = 2e-2  # of max |plain|: a probability truncated one step apart
MAIN_SHAPE = (64, 197, 2304)  # ViT-B/16 @224, the largest serving bucket


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (there is no CPU fallback)")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, runs: int = 10, warmup: int = 3) -> list:
    """Per-call device times (ms) by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def race(kernel, plain) -> tuple:
    """Median ms of kernel and plain, timed in turns plain, kernel,
    kernel, plain (10 runs each turn)."""
    p1 = time_ms(plain)
    k1 = time_ms(kernel)
    k2 = time_ms(kernel)
    p2 = time_ms(plain)
    return statistics.median(k1 + k2), statistics.median(p1 + p2)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def kernel_phase(dev, smi: str) -> dict:
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8,
        packed_attention_int8_plain, packed_attention_plain)

    g = torch.Generator().manual_seed(0)
    res = {}

    def check(name, err, tol):
        ok = err <= tol
        log(f"[kernels] {name}: max_abs_err {err!r} (tolerance {tol!r}) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{name}: error {err} > {tol}")
        return err

    with torch.inference_mode():
        # K1, main path shape, bf16, unmasked
        x = torch.randn(MAIN_SHAPE, generator=g).to(torch.bfloat16).to(dev)
        e_k1 = check("K1 bf16 [64,197,2304]",
                     max_err(packed_attention(x, 12), packed_attention_plain(x, 12)),
                     K1_TOL[torch.bfloat16])
        k1_ms, k1_plain = race(lambda: packed_attention(x, 12),
                               lambda: packed_attention_plain(x, 12))
        # K1 masked and f32
        xs = torch.randn(4, 197, 2304, generator=g).to(dev)
        mb = (torch.rand(4, 1, 197, 197, generator=g) < 0.7).to(dev)
        ma = (-100.0 * (torch.rand(4, 12, 197, 197, generator=g) < 0.3).float()).to(dev)
        xb = xs.to(torch.bfloat16)
        check("K1 bf16 [4,197,2304] bool mask [4,1,197,197]",
              max_err(packed_attention(xb, 12, mask=mb),
                      packed_attention_plain(xb, 12, mask=mb)),
              K1_TOL[torch.bfloat16])
        check("K1 bf16 [4,197,2304] additive mask [4,12,197,197]",
              max_err(packed_attention(xb, 12, mask=ma),
                      packed_attention_plain(xb, 12, mask=ma)),
              K1_TOL[torch.bfloat16])
        check("K1 f32 [4,197,2304] (tf32 off)",
              max_err(packed_attention(xs, 12), packed_attention_plain(xs, 12)),
              K1_TOL[torch.float32])

        # K3, main path shape: per-section quantized qkv
        xf = torch.randn(MAIN_SHAPE, generator=g).to(dev) * 0.5
        sec = xf.reshape(-1, 3, 768).abs().amax(dim=(0, 2)) / 127.0
        q = torch.clamp(torch.round(xf / sec.repeat_interleave(768)), -127, 127).to(torch.int8)
        got, want = packed_attention_int8(q, sec, 12), packed_attention_int8_plain(q, sec, 12)
        e_k3 = check("K3 int8 [64,197,2304] bf16 out", max_err(got, want),
                     K3_BF16_REL_TOL * want.float().abs().max().item())
        inv = 127.0 / want.float().abs().amax()
        gq = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True)
        wq = packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv, int8_out=True)
        delta = (gq.int() - wq.int()).abs()
        same = (delta == 0).float().mean().item()
        log(f"[kernels] K3 int8 [64,197,2304] int8 out: max |delta| "
            f"{delta.max().item()} (tolerance 1), exactly equal {same!r} "
            f"(tolerance >= 0.99)")
        if delta.max().item() > 1 or same < 0.99:
            raise AssertionError("K3 int8 out disagrees with its plain version")
        k3_ms, k3_plain = race(
            lambda: packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True),
            lambda: packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv,
                                                int8_out=True))
    torch.cuda.synchronize()
    log(f"[kernels] K1 bf16 [64,197,2304]: kernel {k1_ms!r} ms, plain {k1_plain!r} ms "
        f"(median of 20, CUDA events; {smi})")
    log(f"[kernels] K3 int8-out [64,197,2304]: kernel {k3_ms!r} ms, plain {k3_plain!r} ms "
        f"(median of 20, CUDA events; {smi})")
    res["K1"] = dict(err=e_k1, ms=k1_ms, plain_ms=k1_plain)
    res["K3"] = dict(err=e_k3, ms=k3_ms, plain_ms=k3_plain)
    return res


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def slice_phase(dev, smi: str) -> dict:
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8)
    from msvit_tpu_torch.serve import BatchingServer

    t0 = time.perf_counter()
    cfg = BaseViTConfig()  # ViT-B/16 @224, bf16 compute, f32 params
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    qparams = quantize_vit_params(model)
    calib = torch.randn(64, 224, 224, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    scales = calibrate_act_scales(qparams, cfg, calib)
    torch.cuda.synchronize()
    log(f"[slice] ViT-B/16 built, quantized, calibrated on 64 images in "
        f"{time.perf_counter() - t0:.1f} s")

    def normalize(u8):  # uint8 wire -> f32 on the device
        return torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0

    def int8_fn(u8):
        with torch.inference_mode():
            f = quantized_vit_apply(qparams, cfg, normalize(u8), act_scales=scales)
            return f[:, 0].float(), torch.ones(len(u8), device=dev)

    def bf16_fn(u8):
        with torch.inference_mode():
            f = model(normalize(u8))["last_hidden_state"]
            return f[:, 0].float(), torch.zeros(len(u8), device=dev)

    images = np.random.default_rng(0).integers(0, 256, (32, 224, 224, 3), dtype=np.uint8)
    responses = []  # (image index, (features, route))
    with BatchingServer(int8_fn, images[0], max_batch=64, max_wait_ms=5.0,
                        small_apply_fn=bf16_fn, small_bucket_max=2) as srv:
        t0 = time.perf_counter()
        srv.warmup()
        log(f"[slice] server warm-up of buckets {srv.buckets} in "
            f"{time.perf_counter() - t0:.1f} s")
        packed_attention.launches = 0
        packed_attention_int8.launches = 0
        t0 = time.perf_counter()
        for i in range(64):  # single requests -> bucket 1 -> bf16
            responses.append((i % 32, srv.submit(images[i % 32]).result(timeout=120)))
        t_single = time.perf_counter() - t0
        t1 = time.perf_counter()
        for burst in range(7):  # bursts of 64 -> int8 buckets
            idx = [(burst * 64 + j) % 32 for j in range(64)]
            futs = [srv.submit(images[i]) for i in idx]
            responses += [(i, f.result(timeout=120)) for i, f in zip(idx, futs)]
        t_burst = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        launches = {"K1": packed_attention.launches, "K3": packed_attention_int8.launches}
        stats = srv.stats()
    log(f"[slice] served {stats['requests']} requests in {wall:.3f} s: "
        f"{stats['requests'] / wall!r} img/s sustained; 64 single requests "
        f"{64 / t_single!r} img/s, 448 in bursts of 64 {448 / t_burst!r} img/s; "
        f"latency p50/p95/p99 {stats['p50_ms']!r} / {stats['p95_ms']!r} / "
        f"{stats['p99_ms']!r} ms; mean batch {stats['mean_batch']!r} over "
        f"{stats['batches']} batches ({smi})")
    log(f"[slice] kernel launches while serving: {launches}")
    if stats["requests"] != 512:
        raise AssertionError(f"served {stats['requests']} of 512 requests")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the served requests")

    # every response: finite, and equal to a direct call of the apply
    # function that served it (0.05 abs: a direct call at another batch
    # size may take another bf16 GEMM algorithm)
    direct = {1.0: int8_fn(images)[0].cpu()}
    direct[0.0] = torch.cat([bf16_fn(images[i:i + 1])[0] for i in range(32)]).cpu()
    worst = 0.0
    routes = [float(route) for _, (_, route) in responses]
    for img, (feat, route) in responses:
        if feat.shape != (768,) or not torch.isfinite(feat).all():
            raise AssertionError(f"response shape {tuple(feat.shape)} or non-finite")
        worst = max(worst, max_err(feat, direct[float(route)][img]))
    log(f"[slice] responses vs direct calls: max abs err {worst!r} (tolerance 0.05); "
        f"{routes.count(1.0)} served int8, {routes.count(0.0)} bf16")
    if worst > 0.05:
        raise AssertionError("served responses disagree with direct calls")

    # bf16 against the same weights on the plain attention path
    xla = ViTModel(dataclasses.replace(cfg, attn_implementation="xla"), device=dev).eval()
    xla.load_state_dict(model.state_dict())
    with torch.inference_mode():
        plain = xla(normalize(images))["last_hidden_state"][:, 0].float().cpu()
    bf16 = bf16_fn(images)[0].cpu()
    int8 = direct[1.0]
    c_plain = min(cos(bf16[i], plain[i]) for i in range(32))
    c_int8 = cos(int8, bf16)
    log(f"[slice] bf16 CLS vs plain attention path: min cosine {c_plain!r} "
        f"(tolerance >= 0.999), max abs err {max_err(bf16, plain)!r}")
    log(f"[slice] int8 CLS vs bf16: cosine {c_int8!r} (tolerance >= 0.98)")
    if c_plain < 0.999:
        raise AssertionError("bf16 features disagree with the plain path")
    if c_int8 < 0.98:
        raise AssertionError("int8 features disagree with bf16")
    return launches


def main() -> None:
    smi = card()
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[build] {os.path.relpath(so, ROOT)} from {len(_build.sources())} "
        f"sources in {time.perf_counter() - t0:.1f} s")

    kernels = kernel_phase(dev, smi)
    launches = slice_phase(dev, smi)
    rows = [
        dict(name="packed_attention", route="cuda",
             source="msvit_tpu_torch/csrc/packed_attention.cu",
             replaces="msvit_tpu/ops/packed_attention.py:118",
             launches=launches["K1"], max_abs_err=kernels["K1"]["err"],
             ms=kernels["K1"]["ms"], plain_ms=kernels["K1"]["plain_ms"]),
        dict(name="packed_attention_int8", route="cuda",
             source="msvit_tpu_torch/csrc/packed_attention_int8.cu",
             replaces="msvit_tpu/ops/packed_attention.py:883",
             launches=launches["K3"], max_abs_err=kernels["K3"]["err"],
             ms=kernels["K3"]["ms"], plain_ms=kernels["K3"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
