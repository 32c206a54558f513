"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (`msvit_tpu_torch`, never JAX) through its main path and
fails (non-zero exit, no result line) if any phase fails:

1. device: a CUDA card is required, there is no CPU fallback; prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the hand-written kernels from `msvit_tpu_torch/csrc`
   (one nvcc per source, in parallel) and prints ptxas's registers and
   spills for the training kernels;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (max abs error against a stated tolerance), then
   both timed with CUDA events in turns (plain, kernel, kernel, plain):
   K1 and K3 (serving), K1-lse and K2 (training; masked, f32 and
   large-logit cases too);
4. serving: ViT-B/16 @224 with seeded random weights, int8-quantized and
   calibrated, served by `BatchingServer` (int8 buckets > 2, bf16 buckets
   of 1 and 2, uint8 requests, CLS features out); checks every response,
   bf16 against the plain attention path, int8 against bf16, and that K1
   and K3 were launched by the served requests;
5. gradient: `ViTForImageClassification` (ViT-B/16, 1000 labels) loss and
   gradients on the kernel path against the plain attention path, same
   weights, bs64;
6. training: `Trainer` (AdamW, warmup-cosine, monitor, EMA, a checkpoint
   every 5 steps) takes 10 steps at bs64; the loss falls, a fresh Trainer
   restores step 10 bit for bit, K1-lse and K2 were launched; one step
   with remat gives the gradients of one without;
7. step time: the train step at bs64 and bs256 (`benchmarks/bench_train.py`'s
   size), ms/step, img/s and peak memory.

The second-to-last line is a JSON object with each kernel's launches in its
path's run (serving for K1 and K3, training for K1-lse and K2), its error
and its time beside the plain version's; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
K3_BF16_REL_TOL = 2e-2  # of max |plain|: a probability truncated one step apart
MAIN_SHAPE = (64, 197, 2304)  # ViT-B/16 @224, the largest serving bucket
# K1-lse out as K1; its lse: 1e-5 of max(1, |lse|) (f32 sums in another
# order).  K2: the kernel mirrors the bf16 roundings of pb and ds, but its
# f32 sums run in another order and can move a rounding by one bf16 step:
# bf16 3e-2 (the JAX package's bar for its backward), f32 1e-4, each of
# max(1, max |plain dqkv|).
LSE_REL_TOL = 1e-5
K2_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# the model's gradient, kernel path vs plain attention path (bf16 compute,
# the same weights): relative loss difference and cosine of all gradients
GRAD_LOSS_REL_TOL = 1e-2
GRAD_COS_TOL = 0.99
LAYERS = 12


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



def train_kernel_phase(dev, smi: str) -> dict:
    """K1-lse and K2 against their plain versions, then timed."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_bwd_plain, packed_attention_lse,
        packed_attention_lse_plain, unpack_qkv)

    g = torch.Generator().manual_seed(2)

    def case(label, x, mask=None):
        gr = torch.randn(*x.shape[:2], x.shape[2] // 3, generator=g).to(x.dtype).to(dev)
        with torch.no_grad():
            o, lse = packed_attention_lse(x, 12, mask=mask)
            wo, wl = packed_attention_lse_plain(x, 12, mask=mask)
            d = packed_attention_bwd(x, mask, wo, wl, gr, 12)
            wd = packed_attention_bwd_plain(x, mask, wo, wl, gr, 12)
        torch.cuda.synchronize()
        for name, t in (("out", o), ("lse", lse), ("dqkv", d)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{label}: non-finite {name}")
        e_o, e_d = max_err(o, wo), max_err(d, wd)
        e_l = ((lse - wl).abs() / wl.abs().clamp_min(1.0)).max().item()
        tol_o = K1_TOL[x.dtype]
        tol_d = K2_TOL[x.dtype] * max(1.0, wd.float().abs().max().item())
        ok = e_o <= tol_o and e_l <= LSE_REL_TOL and e_d <= tol_d
        log(f"[train-kernels] {label}: K1-lse out max_abs_err {e_o!r} (tolerance "
            f"{tol_o!r}), lse rel err {e_l!r} (tolerance {LSE_REL_TOL!r}); K2 "
            f"dqkv max_abs_err {e_d!r} (tolerance {tol_d!r}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{label}: K1-lse/K2 disagree with plain")
        return e_o, e_d, (x, gr, wo, wl)

    x = torch.randn(MAIN_SHAPE, generator=g).to(torch.bfloat16).to(dev)
    e_fwd, e_bwd, (x, gr, wo, wl) = case("bf16 [64,197,2304]", x)
    xs = torch.randn(4, 197, 2304, generator=g).to(dev)
    mb = torch.rand(4, 1, 197, 197, generator=g) < 0.7
    mb[0, 0, 5, :] = False  # one fully masked row
    ma = -100.0 * (torch.rand(4, 12, 197, 197, generator=g) < 0.3).float()
    case("bf16 [4,197,2304] bool mask [4,1,197,197], one row fully masked",
         xs.to(torch.bfloat16), mb.to(dev))
    case("bf16 [4,197,2304] additive mask [4,12,197,197]", xs.to(torch.bfloat16),
         ma.to(dev))
    case("f32 [4,197,2304] (tf32 off)", xs)
    big = xs.clone()
    big[..., :1536] *= 12.0  # q and k: logits in the hundreds
    q, k, _ = unpack_qkv(big, 12)
    s_max = (torch.matmul(q, k.transpose(-1, -2)) * 0.125).abs().max().item()
    if s_max <= 150:
        raise AssertionError(f"large-logit case: max |s| {s_max} <= 150")
    case(f"f32 [4,197,2304] large logits (max |s| {s_max:.1f})", big)

    with torch.no_grad():
        f_ms, f_plain = race(lambda: packed_attention_lse(x, 12),
                             lambda: packed_attention_lse_plain(x, 12))
        b_ms, b_plain = race(lambda: packed_attention_bwd(x, None, wo, wl, gr, 12),
                             lambda: packed_attention_bwd_plain(x, None, wo, wl, gr, 12))
    torch.cuda.synchronize()
    log(f"[train-kernels] K1-lse bf16 [64,197,2304]: kernel {f_ms!r} ms, plain "
        f"{f_plain!r} ms (median of 20, CUDA events; {smi})")
    log(f"[train-kernels] K2 bf16 [64,197,2304]: kernel {b_ms!r} ms, plain "
        f"{b_plain!r} ms (median of 20, CUDA events; {smi})")
    return {"K1-lse": dict(err=e_fwd, ms=f_ms, plain_ms=f_plain),
            "K2": dict(err=e_bwd, ms=b_ms, plain_ms=b_plain)}


def _training_counts():
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_lse)

    return {"K1-lse": packed_attention_lse.launches,
            "K2": packed_attention_bwd.launches}


def _reset_training_counts():
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_lse)

    packed_attention_lse.launches = 0
    packed_attention_bwd.launches = 0


def _batch(dev, bs: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"pixel_values": torch.randn(bs, 224, 224, 3, generator=g).to(dev),
            "labels": torch.randint(0, 1000, (bs,), generator=g).to(dev)}


def _classifier(dev, seed: int, **overrides):
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification

    cfg = dataclasses.replace(BaseViTConfig(), **overrides)  # ViT-B/16 @224
    return ViTForImageClassification(
        cfg, 1000, generator=torch.Generator().manual_seed(seed), device=dev)


def _ce_loss(model, batch, gen):
    logits = model(batch["pixel_values"], generator=gen)
    return F.cross_entropy(logits, batch["labels"]), {}


def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = _ce_loss(model, batch, None)
    loss.backward()
    flat = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    return loss.item(), flat


def gradient_phase(dev, smi: str) -> None:
    """The model's loss and gradients on the kernel path against the plain
    attention path (`attn_implementation="xla"`), the same weights."""
    model = _classifier(dev, 0)
    plain = _classifier(dev, 0, attn_implementation="xla")
    plain.load_state_dict(model.state_dict())
    batch = _batch(dev, 64, 3)
    _reset_training_counts()
    lk, gk = _grads(model, batch)
    counts = _training_counts()
    lp, gp = _grads(plain, batch)
    rel, c = abs(lk - lp) / abs(lp), cos(gk, gp)
    log(f"[gradient] ViT-B/16 classifier bs64: loss kernel path {lk!r}, plain "
        f"path {lp!r}, relative difference {rel!r} (tolerance {GRAD_LOSS_REL_TOL!r}); "
        f"cosine of the gradients {c!r} (tolerance >= {GRAD_COS_TOL!r}); "
        f"launches {counts}")
    if counts != {"K1-lse": LAYERS, "K2": LAYERS}:
        raise AssertionError(f"launches {counts}, want {LAYERS} each")
    if not (rel <= GRAD_LOSS_REL_TOL and c >= GRAD_COS_TOL):
        raise AssertionError("kernel-path gradients disagree with the plain path")


def warmup_cosine(peak: float, warmup: int, total: int):
    def lr(step: int) -> float:
        if step < warmup:
            return peak * (step + 1) / warmup
        t = (step - warmup) / max(1, total - warmup)
        return 0.5 * peak * (1.0 + math.cos(math.pi * min(1.0, t)))

    return lr


def training_phase(dev, smi: str) -> dict:
    """`Trainer` for 10 steps, resume, and one remat step."""
    from msvit_tpu_torch.train import Trainer, make_optimizer

    batch = _batch(dev, 64, 4)
    sched = warmup_cosine(5e-4, 3, 10)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        def trainer(model):
            return Trainer(_ce_loss, make_optimizer(sched, weight_decay=0.05), model,
                           checkpoint_dir=os.path.join(tmp, "ckpt"), save_every=5,
                           metrics_path=os.path.join(tmp, "metrics.jsonl"),
                           log_every=1, monitor=True, ema_decay=0.99)

        tr = trainer(_classifier(dev, 0))
        _reset_training_counts()
        t0 = time.perf_counter()
        tr.fit(itertools.repeat(batch), num_steps=10, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _training_counts()
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        losses = [r["loss"] for r in records]
        log(f"[training] 10 steps at bs64 in {wall:.2f} s (checkpoints at 5 and 10, "
            f"host reads every step); losses {losses}; launches {launches}")
        if len(losses) != 10 or not all(math.isfinite(v) for v in losses):
            raise AssertionError("a training loss is missing or not finite")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall over 10 steps")
        if not all(r["grads_finite"] == 1.0 for r in records):
            raise AssertionError("a step had non-finite gradients")
        if launches != {"K1-lse": 10 * LAYERS, "K2": 10 * LAYERS}:
            raise AssertionError(f"launches {launches}, want {10 * LAYERS} each")

        fresh = trainer(_classifier(dev, 1))
        step = fresh.restore()
        same_p = all(torch.equal(a, b) for a, b in
                     zip(fresh.model.state_dict().values(), tr.model.state_dict().values()))
        same_e = all(torch.equal(fresh.ema_params[n], tr.ema_params[n])
                     for n in tr.ema_params)
        log(f"[training] fresh Trainer restored step {step}: params equal {same_p}, "
            f"EMA equal {same_e}")
        if step != 10 or not (same_p and same_e):
            raise AssertionError("resume is not bit for bit")
        del tr, fresh

    model = _classifier(dev, 5)
    remat = _classifier(dev, 5, remat=True)
    remat.load_state_dict(model.state_dict())
    _, g_plain = _grads(model, batch)
    _reset_training_counts()
    _, g_remat = _grads(remat, batch)
    counts = _training_counts()
    diff = (g_remat - g_plain).abs().max().item()
    tol = 1e-6 * g_plain.abs().max().item()
    log(f"[training] remat step: max |grad difference| {diff!r} (tolerance {tol!r}, "
        f"1e-6 of max |grad|; bit for bit: {diff == 0.0}), launches {counts} "
        f"(K1-lse twice per layer, K2 once)")
    if diff > tol:
        raise AssertionError("remat gradients differ")
    if counts != {"K1-lse": 2 * LAYERS, "K2": LAYERS}:
        raise AssertionError(f"remat launches {counts}")
    return launches


def step_time_phase(dev, smi: str) -> None:
    """The train step (forward, backward, AdamW) at bs64 and bs256."""
    from msvit_tpu_torch.train import make_optimizer, train_step_fn

    for bs in (64, 256):
        model = _classifier(dev, 0)
        opt = make_optimizer(1e-4)
        state = opt.init(model)
        step = train_step_fn(_ce_loss, opt)
        batch = _batch(dev, bs, 6)
        for _ in range(2):  # warm-up
            step(model, state, batch, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            loss, _ = step(model, state, batch, None)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not math.isfinite(loss.item()):
            raise AssertionError("step-time run: non-finite loss")
        log(f"[step-time] ViT-B/16 train step bs{bs}: {dt * 1e3!r} ms/step, "
            f"{bs / dt!r} img/s, peak memory {peak!r} GiB (5 steps after 2 of "
            f"warm-up, host clock; {smi})")
        del model, state, step, batch
        torch.cuda.empty_cache()


def ptxas_lines() -> list:
    """Registers and spills of the training kernels from ptxas's report."""
    from msvit_tpu_torch.ops import _build

    out, name = [], None
    for line in _build.ptxas_report().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(r"lse_kernel|packed_bwd", name):
            kern = re.search(r"(packed_(?:bwd_dq|bwd_dkv|attention_lse)_kernel)",
                             name).group(1)
            dh = re.search(r"Li(\d+)E", name).group(1)
            dt = "bf16" if "bfloat16" in name else "f32"
            out.append(f"{kern} {dt} dh{dh}: {m.group(1)} registers, {spill}")
    return out


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

    for line in ptxas_lines():
        log(f"[build] ptxas: {line}")

    kernels = kernel_phase(dev, smi)
    kernels.update(train_kernel_phase(dev, smi))
    launches = slice_phase(dev, smi)
    torch.cuda.empty_cache()
    gradient_phase(dev, smi)
    torch.cuda.empty_cache()
    launches.update(training_phase(dev, smi))
    torch.cuda.empty_cache()
    step_time_phase(dev, smi)
    src = "msvit_tpu_torch/csrc/"
    tpu = "msvit_tpu/ops/packed_attention.py:"
    rows = [
        dict(name=name, route="cuda", source=src + cu, replaces=tpu + line,
             launches=launches[k], max_abs_err=kernels[k]["err"],
             ms=kernels[k]["ms"], plain_ms=kernels[k]["plain_ms"])
        for k, name, cu, line in (
            ("K1", "packed_attention", "packed_attention.cu", "118"),
            ("K3", "packed_attention_int8", "packed_attention_int8.cu", "883"),
            ("K1-lse", "packed_attention_lse", "packed_attention_lse.cu", "118"),
            ("K2", "packed_attention_bwd", "packed_attention_bwd.cu", "682"),
        )
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
