"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (`msvit_tpu_torch`, never JAX) through its main path and
fails (non-zero exit, no result line) if any phase fails:

1. device: a CUDA card is required, there is no CPU fallback; prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the hand-written kernels from `msvit_tpu_torch/csrc`
   (one nvcc per source, in parallel) and prints ptxas's registers and
   spills for the training (the bf16 pair on the tensor cores), the fused,
   flash, banded and int8 kernels;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (max abs error against a stated tolerance), then
   both timed with CUDA events in turns (plain, kernel, kernel, plain):
   K1 and K3 (serving; K3 on the int8 tensor cores also alone by
   `torch.profiler`, with its share bit-equal to plain, its rate, its
   blocks per SM and K1 beside it as the bf16 yardstick), K1-lse and K2
   (training; masked, f32, large-logit in f32 and bf16 and dh-128 cases
   too; their achieved TFLOP/s and share of the bound);
4. serving: ViT-B/16 @224 with seeded random weights, int8-quantized and
   calibrated, served by `BatchingServer` (int8 buckets > 2, bf16 buckets
   of 1 and 2, uint8 requests, CLS features out); checks every response,
   bf16 against the plain attention path, int8 against bf16, and that K1
   and K3 were launched by the served requests; the int8 bs64 forward's
   device time and K3's share of it (`torch.profiler`);
5. gradient: `ViTForImageClassification` (ViT-B/16, 1000 labels) loss and
   gradients on the kernel path against the plain attention path, same
   weights, bs64;
6. training: `Trainer` (AdamW, warmup-cosine, monitor, EMA, a checkpoint
   every 5 steps) takes 10 steps at bs64; the loss falls, a fresh Trainer
   restores step 10 bit for bit, K1-lse and K2 were launched; one step
   with remat gives the gradients of one without;
7. step time: the train step at bs64 and bs256 (`benchmarks/bench_train.py`'s
   size), ms/step, img/s and peak memory;
8. multistate serving at `bench.py`'s config (ViT-B/8 @224, 816 tokens,
   spectral clustering at layers 4, 6, 8 and 10), seeded weights, int8
   calibrated on 8 images: without clustering events the int8 (K4) and
   bf16 (K5) forwards against the plain attention path and int8 against
   bf16; with them, valid outputs, K4 and K5 launched 11 times per forward
   of their own, the partition's agreement with the plain path, ms/batch,
   img/s, clustering's share, peak memory and host syncs; each forward's
   device time and K4's or K5's share of it (`torch.profiler`);
9. fused kernels: K4 and K5 against their plain versions at [8,12,816,64]
   with the soft mask of the served partition (also a bool mask with a
   fully masked row, f32, and cross-context K/V), the share of elements
   bit-equal to plain, then timed through the wrapper and alone, with the
   achieved TFLOP/s and share of the bound; the kernel's blocks per SM;
10. multistate training kernels: K5-lse and K6 against their plain versions
   at [8,12,816,64] (the served partition's soft mask in bf16 and f32, a
   bool mask with a fully masked row, cross-context K/V, large logits, 6
   heads of 128, mask rows that are not 16-byte aligned: Nk 813 bool and
   814 f32), then timed (each also alone, with its TFLOP/s);
11. multistate gradient: `MultiStateViTForImageClassification` at
   `benchmarks/bench_multistate_train_r3.py`'s config (shared-anchor NCut,
   bs8) on the kernel path against the plain attention path, the loss and
   the TX/RX/classifier gradients, without and with clustering events;
12. multistate training: `Trainer` takes 10 steps of the TX/RX tokens and
   the classifier; the loss falls, frozen weights stay bit-equal, K5-lse
   and K6 run 11 times a step; ms/step, memory, host syncs, the step's
   device time and K5-lse and K6's share of it (`torch.profiler`);
13. the fine-tune example (`python -m msvit_tpu_torch.examples.train_multistate
   --steps 3`, patch 16: K1-lse and K2 with the soft mask);
14. the int8 apply's other attention modes at `bench.py`'s 224-px config:
   `attn_mode="int8"` (K9, calibrated scales) and `"banded"` (K10), each
   against `"bf16"` without clustering events, and with them valid outputs,
   11 launches per forward, the partition's agreement, ms/batch; the int8
   forward's device time and K9's share of it;
15. multistate serving at 448 px (`benchmarks/bench_multistate.py`'s
   `i448:shared1024/256`: 3168 tokens, shared-anchor NCut), the seeded
   scene at 448: the bf16 and int8 forwards (K7 in 11 layers, K4 and K5 in
   none) against the plain attention path without clustering events; with
   them valid outputs; the banded forward (K10 in 11 layers) against the
   dense one, the same weights and draws (in bf16 the partitions'
   agreement and the patch-token cosine, in f32 equal partitions);
   ms/batch, img/s, peak memory, host syncs of each;
16. flash kernels: K7 and K7-lse against their plain versions at
   [8,12,3168,64] with the 448 partition's soft mask (also f32, a bool mask
   with a fully masked row, Nq 197 x Nk 3168), `FlashAttentionFunction`'s
   gradients (K7-lse + K6) against the plain versions, then K7 timed; K6
   against its plain version at [8,12,3168,64], timed;
17. banded kernel: K10 against its plain version on the token rows of the
   448 partition ([8, 32+3136, 2304]; also one cluster, the layers before
   the first event) and the 224 one ([8, 32+784, 2304]), then timed;
18. masked int8 kernel: K9 against its plain version at [8,816,2304] with
   the 224 partition's soft mask and a bool mask (its fully masked row
   mean(V)), bf16 and int8 out, the share bit-equal to plain, then timed
   through the wrapper and alone, beside bf16 K4 at the same shape and
   mask; its blocks per SM;
19. grouped kernels: K1, K1-lse and K2 at the shapes of the TPU's
   head-grouped functions K8a and K8b, which they stand for: bf16
   [64,785,2304], f32 [16,785,2304], the soft-masked [8,816,2304], masked
   f32 [64,197,2304], large logits; then timed at [64,785,2304];
20. dense pretraining: `pretrain_synthetic.pretrain` at `--preset b8`
   (ViT-B/8 @224, 785 tokens) for 10 steps at bs64 with the clip at 1.0 on
   256 scenes made in memory, then the held-out eval: falling loss, K1-lse
   and K2 12 times a step, K1 12 times per eval batch, checkpoint and
   summary; the step's time fed by `prefetch_to_device`, from resident
   batches and by blocking copies, peak memory, host syncs;
21. the same example for 3 steps with `--qk-norm` and with `--dtype f32
   --preset b16`; the qk-norm model's gradients on the kernel path against
   the plain attention path; a clipped step's gradients;
22. bootstrap: the 10-step checkpoint through `train_multistate --preset b8
   --ckpt` (the trunk bit-equal after the transfer; 3 steps, K5-lse and K6
   11 times a step).

Every kernel is timed beside the least time the card could take for its
work (`bound`) and, where one PyTorch call computes the same function,
that call (`scaled_dot_product_attention` or its backward; the port never
calls it).  The second-to-last line is a JSON object with each kernel's
launches in its path's run (serving for K1 and K3, training for K1-lse and
K2, the clustered multistate forwards for K4 and K5, multistate training
for K5-lse and K6, the clustered 448-px bf16 forward for K7, the 224-px
int8-attention forward for K9, the 448-px banded forward for K10, the
ViT-B/8 pretrain run for the K8a, K8a-lse and K8b rows), its error, its time beside the plain version's, the library call's and the
bound, and its share of the bound (K6 and K10 also at their other timed
shapes); the last is `{"ok": true, "device": {...}}`.
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
import warnings

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
# multistate serving at the bench config: ViT-B/8 @224, 784 patch tokens
# + 2 x 16 TX/RX slots, batch 8.  K4/K5 take K1's tolerances (both sides
# round p to bf16 into P.V, K5 against the running max where its plain
# version rounds against the row's max, and f32 sums in another order can
# move a rounding by one bf16 step), each of max(1, max |plain|): under a
# real partition a row may attend a few keys only, its output near a single
# value of V, where one bf16 step is 2^-8 of it
MS_BATCH = 8
MS_CLUSTERS = 16
MS_SHAPE = (MS_BATCH, 12, 816, 64)  # the attention's [B, H, N, dh]
MS448_SHAPE = (MS_BATCH, 12, 3168, 64)  # at 448 px: 3136 patch tokens + 32
# kernel path vs plain attention path, the same weights, no clustering
# event.  bf16: the parity bar.  int8: every activation is requantized to
# int8 at a static scale, so a one-ulp difference at a rounding boundary
# moves a whole int8 step and the two paths' roundings decorrelate over 12
# layers: they sit about twice as far apart as each sits from bf16 (int8 vs
# bf16 0.9989 measured on an NVIDIA H100, so ~0.9978), hence 0.995
MS_BF16_COS = 0.999
MS_INT8_COS = 0.995
# attn_mode="int8" (K9) against "bf16" (K4), the int8 GEMMs alike, no
# clustering event: K9 also quantizes each probability to a 1/127 step
# (truncating; the sum of the quantized probabilities divides) and the
# attention output to int8 at the calibrated proj scale, per layer, where
# "bf16" keeps both in bf16; two quantizations more in each of 11 layers,
# so the int8-vs-bf16 bar of the multistate phase: 0.98
MS_INT8_ATTN_COS = 0.98
# the banded forward's partition against the dense one's in bf16: at the
# 448-px scene the later clustering events split groups of near-identical
# tokens, and bf16 rounding moves a few of them whatever the kernel (the
# plain attention path against the dense kernel path: purity 0.99964 on
# NVIDIA H100 80GB HBM3, 700 W); in f32 the partitions are equal
MS_PARTITION_PURITY = 0.999
# multistate training at `benchmarks/bench_multistate_train_r3.py`'s config
# (ViT-B/8 @224, shared-anchor NCut, 10 labels, bs8).  K5-lse out and lse as
# K5 and K1-lse.  K6: the kernel rounds p (into dV) and ds (into dQ, dK) to
# the compute dtype as the plain version does, but its f32 sums run in
# another order and can move a rounding by one bf16 step: bf16 2e-2, f32
# 1e-4, each of max(1, max |plain|).  The model's loss and trainable
# gradients on the kernel path against the plain attention path: relative
# loss 1e-2, per-tensor cosine 0.999 (bf16 compute either way)
MS_LABELS = 10
K6_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MS_GRAD_LOSS_REL_TOL = 1e-2
MS_GRAD_COS = 0.999
# the least time of a call (bound_ms): the larger of its bytes (each input
# read once, each output written once) over the memory rate and its
# operations over the peak rate of their type (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


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


def device_ms(fn, pattern: str, kernels: int = 1, runs: int = 10) -> float:
    """Device time (ms) per call of the kernels whose names match `pattern`
    (`kernels` launches of them a call; `runs` calls): a kernel alone,
    without the host work and launches around it.  Per kernel name, the
    median of its launches' times in a whole profile (`device_profile`)."""
    return device_profile(fn, pattern, kernels, runs, median=True)[1]


def device_profile(fn, pattern: str, kernels: int, runs: int = 3,
                   median: bool = False) -> tuple:
    """Device time (ms) per call of `fn`, summed over every kernel, copy and
    set it ran on the card, and the part of it in the kernels whose names
    match `pattern` (`torch.profiler`, `runs` calls after one of warm-up;
    `median`: per name, the median launch times its launches per call).
    A call launches `kernels` of those.  The profiler can lose the first
    few launches after it starts (on the H100: 3 of 10 calls of K4; a
    mark after 2 calls of K4, or first, even 50 ms in), so the counted
    calls sit between two marks (`torch.cuda._sleep`'s spin kernel), each
    behind or before 64 one-element adds: a profile without both marks, or
    with another count than runs x kernels between them, is taken again,
    at most twice, and then the readout fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(64):
                pad.add_(1)
            torch.cuda._sleep(1)
            for _ in range(runs):
                fn()
            torch.cuda._sleep(1)
            for _ in range(64):
                pad.add_(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) == 2:
            events = events[marks[0] + 1:marks[1]]
            matched = [e for e in events if re.search(pattern, e.name)]
            if len(matched) == runs * kernels:
                break
            log(f"[profile] {len(matched)} of {runs * kernels} launches matching "
                f"{pattern!r} between the marks: taken again")
        else:
            adds = [i for i, e in enumerate(events) if "spin_kernel" not in e.name
                    and not re.search(pattern, e.name)]
            log(f"[profile] {len(marks)} of 2 marks in the profile (at {marks} of "
                f"{len(events)} events; other kernels at {adds[:3]}..{adds[-3:]}): taken again")
    else:
        raise AssertionError(f"torch.profiler lost launches matching {pattern!r} in three "
                             f"profiles of {runs} calls")
    total = sum(e.device_time_total for e in events)
    if median:
        times = {}
        for e in matched:
            times.setdefault(e.name, []).append(e.device_time_total)
        part = sum(statistics.median(t) * len(t) for t in times.values())
    else:
        part = sum(e.device_time_total for e in matched)
    return total / runs / 1e3, part / runs / 1e3


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def library_ms(fn) -> float:
    """Median ms of 20 CUDA-event runs of the PyTorch call that computes a
    kernel's function (its yardstick; the port never calls it)."""
    return statistics.median(time_ms(fn, runs=20))


def bound(inputs, outputs, ops: float, dtype) -> dict:
    """The least time the card could take for a call that reads `inputs`
    once, writes `outputs` once and does `ops` operations of `dtype`:
    {"bound_ms", "bound_by"}."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs) if t is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def attn_ops(b: int, h: int, nq: int, nk: int, dh: int, products: int) -> float:
    """Operations of `products` [Nq, Nk] x dh matrix products per head."""
    return 2.0 * products * b * h * nq * nk * dh


def rate(ops: float, ms: float, lim: dict) -> str:
    """Achieved rate of a call of `ops` operations in `ms`, and its share of
    the bound."""
    return (f"{ops / ms / 1e9!r} TFLOP/s achieved, {lim['bound_ms'] / ms!r} of its "
            f"bound")


def sdpa(q, k, v, mask=None):
    """The library yardstick: one `scaled_dot_product_attention` call; a
    bool mask as is, an additive one cast to q's dtype."""
    if mask is not None and mask.dtype != torch.bool:
        mask = mask.to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_bwd(q, k, v, g, mask=None):
    """A function timing the backward of `sdpa` for cotangent g (the
    forward runs once, outside it)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = sdpa(*leaves, mask)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def kernel_phase(dev, smi: str) -> dict:
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8,
        packed_attention_int8_plain, packed_attention_plain, unpack_qkv)

    g = torch.Generator().manual_seed(0)
    res = {}

    def check(name, err, tol):
        return _check("kernels", name, err, tol)

    with torch.inference_mode():
        # K1, main path shape, bf16, unmasked
        x = torch.randn(MAIN_SHAPE, generator=g).to(torch.bfloat16).to(dev)
        out = packed_attention(x, 12)
        e_k1 = check("K1 bf16 [64,197,2304]", max_err(out, packed_attention_plain(x, 12)),
                     K1_TOL[torch.bfloat16])
        k1_ms, k1_plain = race(lambda: packed_attention(x, 12),
                               lambda: packed_attention_plain(x, 12))
        k1_lib = library_ms(lambda: sdpa(*unpack_qkv(x, 12)))
        k1_alone = device_ms(lambda: packed_attention(x, 12), "packed_mma_kernel")
        b, n, d3 = MAIN_SHAPE
        ops = attn_ops(b, 12, n, n, d3 // 36, 2)
        k1_bound = bound([x], [out], ops, torch.bfloat16)
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
        _, q, sec = int8_qkv(g, MAIN_SHAPE, dev, scale=0.5)
        got, want = packed_attention_int8(q, sec, 12), packed_attention_int8_plain(q, sec, 12)
        e_k3 = check("K3 int8 [64,197,2304] bf16 out", max_err(got, want),
                     K3_BF16_REL_TOL * want.float().abs().max().item())
        inv = 127.0 / want.float().abs().amax()
        gq = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True)
        wq = packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv, int8_out=True)
        delta = (gq.int() - wq.int()).abs()
        same = (delta == 0).float().mean().item()
        same_bf16 = (got == want).float().mean().item()
        log(f"[kernels] K3 int8 [64,197,2304] int8 out: max |delta| "
            f"{delta.max().item()} (tolerance 1), exactly equal {same!r} "
            f"(tolerance >= 0.99); bf16 out bit-equal to plain on {same_bf16!r} "
            f"of the elements")
        if delta.max().item() > 1 or same < 0.99:
            raise AssertionError("K3 int8 out disagrees with its plain version")
        k3_ms, k3_plain = race(
            lambda: packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True),
            lambda: packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv,
                                                int8_out=True))
        k3_alone = device_ms(
            lambda: packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True),
            "packed_attention_int8_kernel")
        k3_bound = bound([q, sec], [gq], ops, torch.int8)
    torch.cuda.synchronize()
    log(f"[kernels] K1 bf16 [64,197,2304]: kernel {k1_ms!r} ms, plain {k1_plain!r} ms, "
        f"library (scaled_dot_product_attention) {k1_lib!r} ms, bound {k1_bound}; "
        f"{rate(ops, k1_ms, k1_bound)} (median of 20, CUDA events; {smi})")
    log(f"[kernels] K3 int8-out [64,197,2304]: kernel {k3_ms!r} ms, plain {k3_plain!r} ms, "
        f"no library call, bound {k3_bound}; {rate(ops, k3_ms, k3_bound)} (median of 20, "
        f"CUDA events; {smi}); the kernel alone {k3_alone!r} ms (device time, "
        f"torch.profiler; {rate(ops, k3_alone, k3_bound)}; the kernel runs q.k twice: "
        f"{1.5 * ops / k3_alone / 1e9!r} TOP/s executed); yardstick K1 bf16 at the same "
        f"shape {k1_ms!r} ms, alone {k1_alone!r} ms")
    log(f"[kernels] {int8_occupancy(64, (b, 12, n), masked=False)} ({smi})")
    res["K1"] = dict(err=e_k1, ms=k1_ms, plain_ms=k1_plain, library_ms=k1_lib,
                     kernel_alone_ms=k1_alone, **k1_bound)
    res["K3"] = dict(err=e_k3, ms=k3_ms, plain_ms=k3_plain, library_ms=None,
                     kernel_alone_ms=k3_alone, bit_equal=same, **k3_bound)
    return res


def int8_qkv(gen, shape: tuple, dev, scale: float = 1.0) -> tuple:
    """Per-section quantized qkv [B, N, 3D] (K3's and K9's input): the f32
    draw times `scale`, its int8 codes and the q, k, v sections' scales."""
    xf = torch.randn(shape, generator=gen).to(dev) * scale
    d = shape[-1] // 3
    sec = xf.reshape(-1, 3, d).abs().amax(dim=(0, 2)) / 127.0
    q = torch.clamp(torch.round(xf / sec.repeat_interleave(d)), -127, 127).to(torch.int8)
    return xf, q, sec


def int8_occupancy(dh: int, shape: tuple, masked: bool) -> str:
    """Blocks per SM of the int8 kernel (K3, or K9 with a bf16, a bool and
    no mask; the runtime's occupancy calculator), and the waves of a
    [B, H, N] call's (H, N / 64, B) grid."""
    import ctypes

    from msvit_tpu_torch.ops import _build

    lib = _build.library()
    per_sm = {}
    for mask, kind in ((("bf16", 2), ("bool", 1), ("none", 0)) if masked else (("none", 0),)):
        got = ctypes.c_int(0)
        _build.check(lib, lib.msvit_packed_attention_int8_occupancy(
            dh, int(masked), kind, ctypes.byref(got)), "msvit_packed_attention_int8_occupancy")
        per_sm[f"{'K9' if masked else 'K3'} {mask} mask"] = got.value
    b, h, n = shape
    tiles = -(-n // 64)
    blocks = b * h * tiles
    slots = torch.cuda.get_device_properties(0).multi_processor_count * list(per_sm.values())[0]
    return (f"int8 kernel blocks per SM at dh {dh}: {per_sm}; {blocks} blocks of "
            f"[{b},{h},{n},{dh}] over {slots} slots: {blocks / slots!r} waves; "
            f"{-(-n // 16)} of {4 * tiles} warps of a head's blocks hold rows")


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def slice_phase(dev, smi: str) -> dict:
    from msvit_tpu_torch.models.base import ViTModel
    from msvit_tpu_torch.models.base.quantized import quantized_vit_apply
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8)
    from msvit_tpu_torch.serve import BatchingServer

    t0 = time.perf_counter()
    cfg, model, qparams, scales = vit_int8(dev)
    torch.cuda.synchronize()
    log(f"[slice] ViT-B/16 built, quantized, calibrated on 64 images in "
        f"{time.perf_counter() - t0:.1f} s")

    def normalize(u8):
        return wire_pixels(u8, dev)

    def int8_fn(u8):
        with torch.inference_mode():
            f = quantized_vit_apply(qparams, cfg, normalize(u8), act_scales=scales)
            return f[:, 0].float(), torch.ones(len(u8), device=dev)

    def bf16_fn(u8):
        with torch.inference_mode():
            f = model(normalize(u8))["last_hidden_state"]
            return f[:, 0].float(), torch.zeros(len(u8), device=dev)

    images = serving_images()
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
    total, k3 = int8_forward_profile(qparams, cfg, scales, normalize(np.concatenate([images] * 2)))
    log(f"[slice] device time per int8 bs64 forward (every kernel, copy and set summed, "
        f"torch.profiler, 3 forwards after 1 of warm-up): {total!r} ms, K3 {k3!r} ms, "
        f"{k3 / total!r} of it ({smi})")
    return launches


def vit_int8(dev) -> tuple:
    """ViT-B/16 @224 (bf16 compute, f32 params) drawn from seed 0, its int8
    weights and the activation scales calibrated on 64 seeded images:
    (cfg, model, qparams, scales)."""
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.quantized import calibrate_act_scales, quantize_vit_params

    cfg = BaseViTConfig()
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    qparams = quantize_vit_params(model)
    calib = torch.randn(64, 224, 224, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    return cfg, model, qparams, calibrate_act_scales(qparams, cfg, calib)


def serving_images() -> np.ndarray:
    """The 32 seeded uint8 images the slice serves."""
    return np.random.default_rng(0).integers(0, 256, (32, 224, 224, 3), dtype=np.uint8)


def wire_pixels(u8: np.ndarray, dev) -> torch.Tensor:
    """uint8 wire images -> f32 in [-1, 1] on the device."""
    return torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0


def int8_forward_profile(qparams, cfg, scales, pix) -> tuple:
    """Device time per int8 forward of ViT-B/16 on `pix` and the part of it
    in K3 (`device_profile`)."""
    from msvit_tpu_torch.models.base.quantized import quantized_vit_apply

    def fwd():
        with torch.inference_mode():
            quantized_vit_apply(qparams, cfg, pix, act_scales=scales)

    return device_profile(fwd, "packed_attention_int8_kernel", cfg.num_hidden_layers)



def _lse_bwd_case(tag: str, gen, label: str, x, mask=None, heads: int = 12) -> tuple:
    """K1-lse (out, lse) and K2 (dqkv from the plain forward's residuals and
    a random cotangent) against their plain versions on packed qkv `x`;
    returns (out error, dqkv error, (x, cotangent, plain out, plain lse))."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_bwd_plain, packed_attention_lse,
        packed_attention_lse_plain)

    gr = torch.randn(*x.shape[:2], x.shape[2] // 3, generator=gen).to(x.dtype).to(x.device)
    with torch.no_grad():
        o, lse = packed_attention_lse(x, heads, mask=mask)
        wo, wl = packed_attention_lse_plain(x, heads, mask=mask)
        d = packed_attention_bwd(x, mask, wo, wl, gr, heads)
        wd = packed_attention_bwd_plain(x, mask, wo, wl, gr, heads)
    torch.cuda.synchronize()
    for name, t in (("out", o), ("lse", lse), ("dqkv", d)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{label}: non-finite {name}")
    e_o, e_d = max_err(o, wo), max_err(d, wd)
    e_l = ((lse - wl).abs() / wl.abs().clamp_min(1.0)).max().item()
    tol_o = K1_TOL[x.dtype]
    tol_d = K2_TOL[x.dtype] * max(1.0, wd.float().abs().max().item())
    ok = e_o <= tol_o and e_l <= LSE_REL_TOL and e_d <= tol_d
    log(f"[{tag}] {label}: K1-lse out max_abs_err {e_o!r} (tolerance "
        f"{tol_o!r}), lse rel err {e_l!r} (tolerance {LSE_REL_TOL!r}); K2 "
        f"dqkv max_abs_err {e_d!r} (tolerance {tol_d!r}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: K1-lse/K2 disagree with plain")
    return e_o, e_d, (x, gr, wo, wl)


def train_kernel_phase(dev, smi: str) -> dict:
    """K1-lse and K2 against their plain versions, then timed."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_bwd_plain, packed_attention_lse,
        packed_attention_lse_plain, unpack_qkv)

    g = torch.Generator().manual_seed(2)

    def case(label, x, mask=None):
        return _lse_bwd_case("train-kernels", g, label, x, mask)

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
    case(f"bf16 [4,197,2304] large logits (max |s| {s_max:.1f} before the cast)",
         big.to(torch.bfloat16))
    # dh 128 (the tensor-core kernels' largest bucket, tiles in dynamic
    # shared memory) on a ragged N
    _lse_bwd_case("train-kernels", g, "bf16 [4,197,2304] 6 heads (dh 128)",
                  xs.to(torch.bfloat16), heads=6)

    with torch.no_grad():
        f_ms, f_plain = race(lambda: packed_attention_lse(x, 12),
                             lambda: packed_attention_lse_plain(x, 12))
        b_ms, b_plain = race(lambda: packed_attention_bwd(x, None, wo, wl, gr, 12),
                             lambda: packed_attention_bwd_plain(x, None, wo, wl, gr, 12))
        qkv = unpack_qkv(x, 12)
        f_lib = library_ms(lambda: sdpa(*qkv))
        b_lib = library_ms(sdpa_bwd(*qkv, gr.reshape(x.shape[0], x.shape[1], 12, -1)
                                    .transpose(1, 2)))
    torch.cuda.synchronize()
    b, n, d3 = MAIN_SHAPE
    f_ops, b_ops = (attn_ops(b, 12, n, n, d3 // 36, k) for k in (2, 5))
    f_bound = bound([x], [wo, wl], f_ops, torch.bfloat16)
    # K2 writes dqkv, x's shape and dtype
    b_bound = bound([x, wo, wl, gr], [x], b_ops, torch.bfloat16)
    log(f"[train-kernels] K1-lse bf16 [64,197,2304]: kernel {f_ms!r} ms, plain "
        f"{f_plain!r} ms, library (scaled_dot_product_attention) {f_lib!r} ms, bound "
        f"{f_bound}; {rate(f_ops, f_ms, f_bound)} (median of 20, CUDA events; {smi})")
    log(f"[train-kernels] K2 bf16 [64,197,2304]: kernel {b_ms!r} ms, plain "
        f"{b_plain!r} ms, library (its backward) {b_lib!r} ms, bound {b_bound}; "
        f"{rate(b_ops, b_ms, b_bound)} (median of 20, CUDA events; {smi})")
    return {"K1-lse": dict(err=e_fwd, ms=f_ms, plain_ms=f_plain, library_ms=f_lib, **f_bound),
            "K2": dict(err=e_bwd, ms=b_ms, plain_ms=b_plain, library_ms=b_lib, **b_bound)}


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
    """The schedule takes the optimizer's device count (a 0-d int32 tensor):
    torch ops only, no host read."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp((step - warmup).float() / max(1, total - warmup), max=1.0)
        return torch.where(step < warmup, peak * (step + 1).float() / warmup,
                           0.5 * peak * (1.0 + torch.cos(math.pi * t)))

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


def multistate_config(**overrides):
    """The multistate serving config of `bench.py::_bench_multistate`."""
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig

    cfg = MultiStateViTConfig(
        patch_size=8, image_size=224, pregeneration_period=4, generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8, num_sample=1024, max_clusters=MS_CLUSTERS,
            eigenvalue_threshold=0.1, ncut_dist="rbf", eig_method="subspace",
            late_num_sample=256))
    return dataclasses.replace(cfg, **overrides)


def scene_pixels(seed: int, k: int = 6, size: int = 224) -> torch.Tensor:
    """[8, size, size, 3] images of 8x8 patches copied from k seeded
    prototypes (plus a little noise), laid out in 4 x 4 blocks of patches
    (7 x 7 at 224 px, 14 x 14 at 448): the tokens fall into k groups, so
    clustering has a partition to find.  (At random weights, N(0, 1) pixels
    give it none: every event keeps one cluster.)  A seed gives the same
    prototypes and block layout at every size."""
    g = torch.Generator().manual_seed(seed)
    protos = torch.randn(k, 8, 8, 3, generator=g) * 3.0
    blocks = torch.randint(0, k, (MS_BATCH, 4, 4), generator=g)
    p = size // 8
    lab = blocks.repeat_interleave(p // 4, 1).repeat_interleave(p // 4, 2)  # [B, p, p]
    x = protos[lab] + 0.1 * torch.randn(MS_BATCH, p, p, 8, 8, 3, generator=g)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(MS_BATCH, size, size, 3)


def _fused_counts() -> dict:
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference)

    return {"K4": fused_attention_inference.launches, "K5": fused_attention.launches}


def _reset_fused_counts() -> None:
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference)

    fused_attention_inference.launches = 0
    fused_attention.launches = 0


def wall_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Mean host ms per call of work that ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def min_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """The smallest per-image cosine."""
    return min(cos(x, y) for x, y in zip(a, b))


def _check_multistate_out(label: str, out: dict, cfg) -> None:
    lh, tx = out["last_hidden_state"], out["cluster_tokens"]
    rt, ids = out["receiver_to_transmitter_attentions"], out["last_cluster_indices"]
    nc = out["num_clusters"]
    b, c, d, n = MS_BATCH, cfg.max_clusters, cfg.hidden_size, cfg.num_patches
    shapes = (tuple(lh.shape), tuple(tx.shape), tuple(rt.shape), tuple(ids.shape))
    if shapes != ((b, n, d), (b, c, d), (b, cfg.num_attention_heads, c, c), (b, n)):
        raise AssertionError(f"{label}: output shapes {shapes}")
    if not all(torch.isfinite(t).all() for t in (lh, tx, rt)):
        raise AssertionError(f"{label}: non-finite outputs")
    if nc.numel() != 1 or not 1 <= int(nc) <= c:
        raise AssertionError(f"{label}: num_clusters {nc.tolist()}")
    if int(ids.min()) < 0 or int(ids.max()) >= int(nc):
        raise AssertionError(f"{label}: cluster ids outside [0, {int(nc)})")


def multistate_phase(dev, smi: str) -> tuple:
    """The multistate encoder served at the bench config, seeded weights:
    the int8 forward (K4) and the bf16 eval forward (K5), each against the
    plain attention path, without and with clustering events; launches,
    outputs, times.  Returns (launches, the int8 run's partition)."""
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales,
        quantize_multistate_params, quantized_multistate_apply)
    from msvit_tpu_torch.utils.rng import Rng

    t0 = time.perf_counter()
    cfg = multistate_config()
    flat = multistate_config(pregeneration_period=LAYERS)  # no clustering event
    model = MultiStateViTEncoderModel(
        cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    state = model.state_dict()

    def twin(c):  # the same weights under another config
        m = MultiStateViTEncoderModel(c, device=dev).eval()
        m.load_state_dict(state)
        return m

    qparams = quantize_multistate_params(model)
    scales = calibrate_multistate_act_scales(qparams, cfg, scene_pixels(1).to(dev), Rng(0))
    pix = scene_pixels(2).to(dev)
    torch.cuda.synchronize()
    log(f"[multistate] ViT-B/8 multistate encoder (816 tokens, 16 cluster slots) built, "
        f"quantized, calibrated on 8 seeded scene images in "
        f"{time.perf_counter() - t0:.1f} s")

    def int8(c, use_kernels=None):
        return quantized_multistate_apply(qparams, c, pix, Rng(3), act_scales=scales,
                                          use_kernels=use_kernels)

    def bf16(m):
        with torch.inference_mode():
            return m(pix, rng=Rng(3))

    # no clustering event: one valid cluster slot; the shave (K4) and the
    # exact softmax differ only in the empty slots' fully penalised rows
    flat_k = twin(flat)
    flat_p = twin(dataclasses.replace(flat, attn_implementation="xla"))
    ik, ip, bk, bp = int8(flat), int8(flat, use_kernels=False), bf16(flat_k), bf16(flat_p)
    c_int8, c_bf16, c_mixed, c_floor = _agree(ik, ip), _agree(bk, bp), _agree(ik, bk), _agree(ip, bp)
    log(f"[multistate] no clustering event, min per-image cosine: bf16 kernel path vs "
        f"plain path {c_bf16!r} (tolerance >= {MS_BF16_COS!r}); int8 kernel path vs "
        f"plain path {c_int8!r} (tolerance >= {MS_INT8_COS!r}); int8 vs bf16 on the kernel "
        f"path {c_mixed!r}, on the plain path {c_floor!r} (tolerance >= 0.98)")
    if c_bf16 < MS_BF16_COS or c_int8 < MS_INT8_COS:
        raise AssertionError("multistate kernel path disagrees with the plain path")
    if min(c_mixed, c_floor) < 0.98:
        raise AssertionError("multistate int8 disagrees with bf16")
    del flat_k, flat_p, ik, ip, bk, bp

    # the bench config: clustering at layers 4, 6, 8 and 10
    _reset_fused_counts()
    ci = int8(cfg)
    n_int8 = _fused_counts()
    _reset_fused_counts()
    cb = bf16(model)
    n_bf16 = _fused_counts()
    torch.cuda.synchronize()
    log(f"[multistate] launches per forward: int8 {n_int8}, bf16 {n_bf16}")
    if n_int8 != {"K4": LAYERS - 1, "K5": 0} or n_bf16 != {"K4": 0, "K5": LAYERS - 1}:
        raise AssertionError(f"launches int8 {n_int8}, bf16 {n_bf16}: want K4 and K5 "
                             f"{LAYERS - 1} times each in its own forward")
    launches = {"K4": n_int8["K4"], "K5": n_bf16["K5"]}
    _check_multistate_out("int8", ci, cfg)
    _check_multistate_out("bf16", cb, cfg)
    cp = int8(cfg, use_kernels=False)
    bfp = bf16(twin(dataclasses.replace(cfg, attn_implementation="xla")))
    for label, got, want in (("int8", ci, cp), ("bf16", cb, bfp)):
        same = (got["last_cluster_indices"] == want["last_cluster_indices"]).float().mean()
        log(f"[multistate] {label} with clustering: num_clusters {int(got['num_clusters'])} "
            f"(plain path {int(want['num_clusters'])}), tokens in the same cluster as "
            f"on the plain path {same.item()!r}; cluster sizes "
            f"{torch.bincount(got['last_cluster_indices'].flatten(), minlength=MS_CLUSTERS).tolist()}")
    del cp, bfp
    torch.cuda.empty_cache()

    syncs = _syncs(lambda: int8(cfg))  # `eigh` checks its error code on the host

    t_int8 = wall_ms(lambda: int8(cfg))
    t_flat = wall_ms(lambda: int8(flat))
    t_bf16 = wall_ms(lambda: bf16(model))
    torch.cuda.reset_peak_memory_stats()
    int8(cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[multistate] int8 forward bs8 with clustering: {t_int8!r} ms/batch "
        f"({MS_BATCH / t_int8 * 1e3!r} img/s); without events {t_flat!r} ms, so "
        f"clustering (4 events) takes {(t_int8 - t_flat) / t_int8!r} of the forward; "
        f"bf16 forward {t_bf16!r} ms/batch ({MS_BATCH / t_bf16 * 1e3!r} img/s); "
        f"peak memory {peak!r} GiB during an int8 forward (bf16 and int8 weights "
        f"resident); host syncs per forward {syncs} (10 runs after 2 of warm-up, "
        f"host clock; {smi})")
    # K4's and K5's kernel (and the CUDA-core kernel, which ran them in bf16
    # before the tensor-core one, so that an older tree reads the same way)
    attn = "flash_mma_kernel|fused_attention_kernel"
    d_int8, k4 = device_profile(lambda: int8(cfg), attn, LAYERS - 1)
    d_bf16, k5 = device_profile(lambda: bf16(model), attn, LAYERS - 1)
    log(f"[multistate] device time per forward with clustering (every kernel, copy and "
        f"set summed, torch.profiler, 3 forwards after 1 of warm-up): int8 {d_int8!r} "
        f"ms, K4 {k4 / d_int8!r} of it; bf16 {d_bf16!r} ms, K5 {k5 / d_bf16!r} of it "
        f"({smi})")
    return launches, (ci["last_cluster_indices"], ci["num_clusters"])


def fused_kernel_phase(dev, smi: str, partition) -> dict:
    """K4 and K5 against their plain versions at the multistate shape, on
    q/k/v views of a packed QKV output, the soft mask of the served
    partition; also a bool mask with a fully masked row, f32, and
    cross-context K/V (Nq 197, Nk 816); then both timed."""
    from msvit_tpu_torch.models.multistate import build_multistate_attention_mask
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference, fused_attention_inference_plain,
        fused_attention_plain)
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, h, n, dh = MS_SHAPE
    g = torch.Generator().manual_seed(8)
    ids, n_clusters = partition
    soft = torch.where(build_multistate_attention_mask(ids, n_clusters, MS_CLUSTERS),
                       0.0, -100.0)  # [8, 1, 816, 816] f32
    mb = torch.rand(b, 1, n, n, generator=g) < 0.7
    mb[0, 0, 5, :] = False  # one fully masked row: mean(V)
    mb = mb.to(dev)
    x = torch.randn(b, n, 3 * h * dh, generator=g).to(dev)
    qf, kf, vf = unpack_qkv(x, h)
    q, k, v = unpack_qkv(x.to(torch.bfloat16), h)
    res = {}
    with torch.inference_mode():
        for name, fn, plain in (("K4", fused_attention_inference, fused_attention_inference_plain),
                                ("K5", fused_attention, fused_attention_plain)):
            cases = [
                (f"bf16 {list(MS_SHAPE)} soft mask of the served partition", (q, k, v), soft),
                (f"bf16 {list(MS_SHAPE)} bool mask [8,1,816,816], one row fully masked",
                 (q, k, v), mb),
                (f"f32 {list(MS_SHAPE)} soft mask (tf32 off)", (qf, kf, vf), soft),
                ("bf16 cross-context Nq 197, Nk 816, soft mask",
                 (q[:, :, :197], k, v), soft[:, :, :197]),
            ]
            errs = []
            for label, (qq, kk, vv), m in cases:
                want = plain(qq, kk, vv, mask=m)
                err = max_err(fn(qq, kk, vv, mask=m), want)
                tol = K1_TOL[qq.dtype] * max(1.0, want.float().abs().max().item())
                log(f"[fused-kernels] {name} {label}: max_abs_err {err!r} (tolerance "
                    f"{tol!r}) {'ok' if err <= tol else 'FAILED'}")
                if err > tol:
                    raise AssertionError(f"{name} {label}: error {err} > {tol}")
                errs.append(err)
            same = (fn(q, k, v, mask=soft) == plain(q, k, v, mask=soft)).float().mean().item()
            log(f"[fused-kernels] {name} bf16 {list(MS_SHAPE)} soft mask: out bit-equal to "
                f"the plain version's on {same!r} of the elements (p rounded to bf16 into "
                f"P.V on both sides)")
            ms, plain_ms = race(lambda: fn(q, k, v, mask=soft),
                                lambda: plain(q, k, v, mask=soft))
            lib = library_ms(lambda: sdpa(q, k, v, soft))
            alone = device_ms(lambda: fn(q, k, v, mask=soft), "flash_mma_kernel")
            ops = attn_ops(b, h, n, n, dh, 2)
            lim = bound([q, k, v, soft], [q], ops, torch.bfloat16)
            torch.cuda.synchronize()
            log(f"[fused-kernels] {name} bf16 {list(MS_SHAPE)} soft mask: kernel {ms!r} ms, "
                f"plain {plain_ms!r} ms, library (scaled_dot_product_attention, the mask "
                f"in bf16) {lib!r} ms, bound {lim}; {rate(ops, ms, lim)} (median of 20, "
                f"CUDA events; {smi}); the kernel alone {alone!r} ms (device time, "
                f"torch.profiler; {rate(ops, alone, lim)})")
            res[name] = dict(err=errs[0], ms=ms, plain_ms=plain_ms, library_ms=lib,
                             kernel_alone_ms=alone, bit_equal=same, **lim)
    log(f"[fused-kernels] {occupancy(dh, (b, h, n))} ({smi})")
    return res


def occupancy(dh: int, shape: tuple) -> str:
    """Blocks per SM of the bf16 K4 and K5 kernel with an f32, a bool and no
    mask (the runtime's occupancy calculator), and the waves of a
    [B, H, N, dh] call's (H, N / 64, B) grid with an f32 mask."""
    import ctypes

    from msvit_tpu_torch.ops import _build

    lib = _build.library()
    per_sm = {}
    for name, shaved in (("K4", 1), ("K5", 0)):
        for mask, kind in (("f32", 2), ("bool", 1), ("none", 0)):
            n = ctypes.c_int(0)
            _build.check(lib, lib.msvit_fused_attention_occupancy(dh, kind, shaved,
                                                                  ctypes.byref(n)),
                         "msvit_fused_attention_occupancy")
            per_sm[f"{name} {mask} mask"] = n.value
    b, h, n = shape
    blocks = b * h * -(-n // 64)
    slots = torch.cuda.get_device_properties(0).multi_processor_count * per_sm["K5 f32 mask"]
    return (f"blocks per SM at dh {dh}: {per_sm}; {blocks} blocks of [{b},{h},{n},{dh}] "
            f"over {slots} slots with the f32 mask: {blocks / slots!r} waves")


def _ms_train_counts() -> dict:
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd
    from msvit_tpu_torch.ops.fused_attention import fused_attention_lse

    return {"K5-lse": fused_attention_lse.launches, "K6": flash_attention_bwd.launches,
            **_fused_counts()}


def _reset_ms_train_counts() -> None:
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd
    from msvit_tpu_torch.ops.fused_attention import fused_attention_lse

    fused_attention_lse.launches = 0
    flash_attention_bwd.launches = 0
    _reset_fused_counts()


def ms_train_kernel_phase(dev, smi: str, partition) -> dict:
    """K5-lse (out, lse) and K6 (dq, dk, dv from the plain forward's
    residuals and a strided cotangent) against their plain versions at the
    multistate shape: q/k/v views of a packed QKV output with the served
    partition's soft mask, the same in f32, a bool mask with a fully
    masked row, cross-context K/V (Nq 197, Nk 816), and large logits (q
    and k x 12, f32); then timed beside `scaled_dot_product_attention` and
    its backward."""
    from msvit_tpu_torch.models.multistate import build_multistate_attention_mask
    from msvit_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention_lse, fused_attention_lse_plain)
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, h, n, dh = MS_SHAPE
    gen = torch.Generator().manual_seed(9)
    ids, n_clusters = partition
    soft = torch.where(build_multistate_attention_mask(ids, n_clusters, MS_CLUSTERS),
                       0.0, -100.0)  # [8, 1, 816, 816] f32
    mb = torch.rand(b, 1, n, n, generator=gen) < 0.7
    mb[0, 0, 5, :] = False  # one fully masked row
    mb = mb.to(dev)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(dev)
    # the cotangent as autograd hands it: a [B, H, N, dh] view of [B, N, H, dh]
    g = torch.randn(b, n, h, dh, generator=gen).to(dev).transpose(1, 2)
    qf, kf, vf = unpack_qkv(x, h)
    q, k, v = unpack_qkv(x.to(torch.bfloat16), h)
    big = x.clone()
    big[..., :2 * h * dh] *= 12.0  # q and k: logits in the hundreds
    qb, kb, vb = unpack_qkv(big, h)
    # the same width as 6 heads of 128
    q6, k6, v6 = unpack_qkv(x.to(torch.bfloat16), 6)
    g6 = g.transpose(1, 2).reshape(b, n, 6, 128).transpose(1, 2)
    cases = [
        (f"bf16 {list(MS_SHAPE)} soft mask of the served partition", (q, k, v), soft, g),
        (f"f32 {list(MS_SHAPE)} soft mask (tf32 off)", (qf, kf, vf), soft, g),
        (f"bf16 {list(MS_SHAPE)} bool mask [8,1,816,816], one row fully masked",
         (q, k, v), mb, g),
        ("bf16 cross-context Nq 197, Nk 816, soft mask", (q[:, :, :197], k, v),
         soft[:, :, :197], g[:, :, :197]),
        (f"f32 {list(MS_SHAPE)} large logits, soft mask", (qb, kb, vb), soft, g),
        ("bf16 [8,6,816,128] soft mask", (q6, k6, v6), soft, g6),
        # mask rows not 16-byte aligned: bool copied a byte, f32 4 bytes a time
        ("bf16 Nq 816, Nk 813, bool mask, one row fully masked",
         (q, k[:, :, :813], v[:, :, :813]), mb[..., :813], g),
        ("bf16 Nq 816, Nk 814, soft mask", (q, k[:, :, :814], v[:, :, :814]),
         soft[..., :814], g),
    ]
    errs = []
    with torch.no_grad():
        for label, (qq, kk, vv), m, gg in cases:
            o, lse = fused_attention_lse(qq, kk, vv, mask=m)
            wo, wl = fused_attention_lse_plain(qq, kk, vv, mask=m)
            got = flash_attention_bwd(qq, kk, vv, wo, gg.to(qq.dtype), wl, m)
            want = flash_attention_bwd_plain(qq, kk, vv, wo, gg.to(qq.dtype), wl, m)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in (o, lse, *got)):
                raise AssertionError(f"K5-lse/K6 {label}: non-finite output")
            e_o = max_err(o, wo)
            tol_o = K1_TOL[qq.dtype] * max(1.0, wo.float().abs().max().item())
            e_l = ((lse - wl).abs() / wl.abs().clamp_min(1.0)).max().item()
            e_d = max(max_err(a, w) for a, w in zip(got, want))
            tol_d = K6_TOL[qq.dtype] * max(1.0, max(w.float().abs().max().item() for w in want))
            ok = e_o <= tol_o and e_l <= LSE_REL_TOL and e_d <= tol_d
            log(f"[ms-train-kernels] {label}: K5-lse out max_abs_err {e_o!r} (tolerance "
                f"{tol_o!r}), lse rel err {e_l!r} (tolerance {LSE_REL_TOL!r}); K6 dq/dk/dv "
                f"max_abs_err {e_d!r} (tolerance {tol_d!r}) {'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{label}: K5-lse/K6 disagree with plain")
            errs.append((e_o, e_d))
        wo, wl = fused_attention_lse_plain(q, k, v, mask=soft)
        same = (fused_attention_lse(q, k, v, mask=soft)[0] == wo).float().mean().item()
        log(f"[ms-train-kernels] K5-lse bf16 {list(MS_SHAPE)} soft mask: out bit-equal to "
            f"the plain version's on {same!r} of the elements (p rounded to bf16 into P.V "
            f"on both sides, against the running max here, the row's max there)")
        gb = g.to(torch.bfloat16)
        f_ms, f_plain = race(lambda: fused_attention_lse(q, k, v, mask=soft),
                             lambda: fused_attention_lse_plain(q, k, v, mask=soft))
        b_ms, b_plain = race(lambda: flash_attention_bwd(q, k, v, wo, gb, wl, soft),
                             lambda: flash_attention_bwd_plain(q, k, v, wo, gb, wl, soft))
        f_lib = library_ms(lambda: sdpa(q, k, v, soft))
        b_lib = library_ms(sdpa_bwd(q, k, v, gb, soft))
        b_alone = device_ms(lambda: flash_attention_bwd(q, k, v, wo, gb, wl, soft),
                            "flash_bwd_d(?:q|kv)_mma_kernel", kernels=2)
        f_alone = device_ms(lambda: fused_attention_lse(q, k, v, mask=soft), "flash_mma_kernel")
    torch.cuda.synchronize()
    f_ops = attn_ops(b, h, n, n, dh, 2)
    f_bound = bound([q, k, v, soft], [wo, wl], f_ops, torch.bfloat16)
    # K6 writes dq, dk, dv: the shapes of q, k, v
    b_bound = bound([q, k, v, wo, gb, wl, soft], [q, k, v], attn_ops(b, h, n, n, dh, 5),
                    torch.bfloat16)
    log(f"[ms-train-kernels] K5-lse bf16 {list(MS_SHAPE)} soft mask: kernel {f_ms!r} ms, "
        f"plain {f_plain!r} ms, library (scaled_dot_product_attention, the mask in bf16) "
        f"{f_lib!r} ms, bound {f_bound}; {rate(f_ops, f_ms, f_bound)} (median of 20, "
        f"CUDA events; {smi}); the kernel alone {f_alone!r} ms (device time, "
        f"torch.profiler; {rate(f_ops, f_alone, f_bound)})")
    b_ops = attn_ops(b, h, n, n, dh, 5)
    log(f"[ms-train-kernels] K6 bf16 {list(MS_SHAPE)} soft mask: kernel {b_ms!r} ms, "
        f"plain {b_plain!r} ms, library (the backward of that call) {b_lib!r} ms, bound "
        f"{b_bound}; {rate(b_ops, b_ms, b_bound)} (5 products; median of 20, CUDA "
        f"events; {smi}); its two kernels alone {b_alone!r} ms (device time, "
        f"torch.profiler)")
    return {"K5-lse": dict(err=errs[0][0], ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                           kernel_alone_ms=f_alone, bit_equal=same, **f_bound),
            "K6": dict(err=errs[0][1], ms=b_ms, plain_ms=b_plain, library_ms=b_lib,
                       kernel_alone_ms=b_alone, **b_bound)}


def ms_train_config(**overrides):
    """The multistate fine-tune config of
    `benchmarks/bench_multistate_train_r3.py` (ViT-B/8 @224, 816 tokens)."""
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig

    cfg = MultiStateViTConfig(
        patch_size=8, image_size=224, pregeneration_period=4, generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8, num_sample=512, max_clusters=MS_CLUSTERS,
            eigenvalue_threshold=0.1, ncut_dist="rbf", shared_anchors=True))
    return dataclasses.replace(cfg, **overrides)


def ms_classifier(dev, cfg):
    """`MultiStateViTForImageClassification` in training mode, weights
    drawn from seed 0 (the same under every config), with the example's
    trainable set (TX/RX tokens, classifier) requiring grad."""
    from msvit_tpu_torch.examples.train_multistate import trainable
    from msvit_tpu_torch.models.multistate import MultiStateViTForImageClassification

    model = MultiStateViTForImageClassification(
        cfg, MS_LABELS, generator=torch.Generator().manual_seed(0), device=dev)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(tuple(name.split("."))))
    return model.train()


def ms_train_grad_phase(dev, smi: str) -> None:
    """The classifier's loss and trainable gradients on the kernel path
    (K5-lse, K6) against the plain attention path, the same weights,
    without and with clustering events."""
    from msvit_tpu_torch.utils.rng import Rng

    pix = scene_pixels(2).to(dev)
    labels = torch.arange(MS_BATCH, device=dev) % MS_LABELS
    for events in (False, True):
        cfg = ms_train_config() if events else ms_train_config(pregeneration_period=LAYERS)
        runs = {}
        for path in ("kernel", "plain"):
            c = cfg if path == "kernel" else dataclasses.replace(cfg, attn_implementation="xla")
            model = ms_classifier(dev, c)
            _reset_ms_train_counts()
            out = model(pix, labels, rng=Rng(7))
            out["loss"].backward()
            torch.cuda.synchronize()
            runs[path] = (out["loss"].item(), _ms_train_counts(),
                          out["last_cluster_indices"], int(out["num_clusters"]),
                          {n: p.grad.detach().clone() for n, p in model.named_parameters()
                           if p.grad is not None})
            del model, out
        (lk, nk, ik, ck, gk), (lp, _, ip, cp, gp) = runs["kernel"], runs["plain"]
        want = {"K5-lse": LAYERS - 1, "K6": LAYERS - 1, "K4": 0, "K5": 0}
        if nk != want:
            raise AssertionError(f"kernel path launches {nk}, want {want}")
        same = (ik == ip).float().mean().item()
        label = "with clustering events" if events else "no clustering event"
        log(f"[ms-train-grad] {label}: num_clusters kernel path {ck}, plain path {cp}; "
            f"tokens in the same cluster {same!r}; launches {nk}")
        if events and not (same == 1.0 and ck == cp):
            log(f"[ms-train-grad] {label}: partitions differ, gradients not compared")
            continue
        rel = abs(lk - lp) / abs(lp)
        coss = {n: cos(gk[n], gp[n]) for n in gp}
        log(f"[ms-train-grad] {label}, partitions equal: loss kernel path {lk!r}, plain "
            f"path {lp!r}, relative difference {rel!r} (tolerance {MS_GRAD_LOSS_REL_TOL!r}); "
            f"gradient cosines {coss} (tolerance >= {MS_GRAD_COS!r}; {smi})")
        if set(gk) != set(gp) or len(gp) != 4:
            raise AssertionError(f"trainable gradients {sorted(gk)} vs {sorted(gp)}")
        if rel > MS_GRAD_LOSS_REL_TOL or min(coss.values()) < MS_GRAD_COS:
            raise AssertionError(f"{label}: kernel-path gradients disagree with the plain path")


def ms_train_phase(dev, smi: str) -> dict:
    """`Trainer` takes 10 steps of the TX/RX tokens and the classifier at
    the bench config on a fixed batch, step s drawing from a generator
    seeded with `fold_in(seed, s)` (dropout and the clustering `Rng`):
    losses, frozen weights, launches, ms/step, memory, host syncs, device
    time per step."""
    from msvit_tpu_torch.examples.train_multistate import loss_fn, trainable
    from msvit_tpu_torch.train import Trainer, make_optimizer

    model = ms_classifier(dev, ms_train_config())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    tr = Trainer(loss_fn, make_optimizer(1e-3, trainable=trainable), model)
    batch = (scene_pixels(2).to(dev), torch.arange(MS_BATCH, device=dev) % MS_LABELS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_ms_train_counts()
    losses, times = [], []
    for s in range(10):  # one `fit` call per step: its loss is read, synchronizing
        t0 = time.perf_counter()
        losses.append(tr.fit(itertools.repeat(batch), num_steps=s + 1, seed=0))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _ms_train_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = _syncs(lambda: tr.fit(itertools.repeat(batch), num_steps=11, seed=0))
    ms = statistics.median(times[1:])
    step = [11]

    def one_step():
        step[0] += 1
        tr.fit(itertools.repeat(batch), num_steps=step[0], seed=0)

    # K5-lse's and K6's kernels (and the CUDA-core kernels that ran K5-lse in
    # bf16 before the tensor-core one, so that an older tree reads the same):
    # a step launches K5-lse and K6's two kernels once a layer
    d_step, attn = device_profile(
        one_step, "flash_mma_kernel|fused_attention_kernel|flash_bwd_d(?:q|kv)",
        3 * (LAYERS - 1))
    unchanged = all(torch.equal(p.detach(), frozen[n]) for n, p in model.named_parameters()
                    if n in frozen)
    log(f"[ms-train] 10 Trainer steps bs{MS_BATCH} (TX/RX + classifier trainable, "
        f"{len(frozen)} frozen tensors): losses {losses}; median {ms!r} ms/step "
        f"({MS_BATCH / ms * 1e3!r} img/s, steps 2-10, host clock, each ending in the "
        f"loss read); peak memory {peak!r} GiB; host syncs per step {syncs}; frozen "
        f"weights bit-equal {unchanged}; launches {launches}; device time per step "
        f"{d_step!r} ms (every kernel, copy and set summed, torch.profiler, 3 steps "
        f"after 1), K5-lse and K6 {attn / d_step!r} of it ({smi})")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError("multistate training: a loss is not finite or did not fall")
    if not unchanged:
        raise AssertionError("multistate training changed a frozen weight")
    want = {"K5-lse": 10 * (LAYERS - 1), "K6": 10 * (LAYERS - 1), "K4": 0, "K5": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    return {"K5-lse": launches["K5-lse"], "K6": launches["K6"]}


def ms_train_example_phase(dev, smi: str) -> None:
    """`python -m msvit_tpu_torch.examples.train_multistate --steps 3`, in
    process (patch 16 @224, 228 tokens: K1-lse and K2 with the soft mask)."""
    from msvit_tpu_torch.examples import train_multistate

    _reset_training_counts()
    t0 = time.perf_counter()
    losses = train_multistate.main(["--steps", "3"])
    torch.cuda.synchronize()
    counts = _training_counts()
    log(f"[ms-train-example] 3 steps in {time.perf_counter() - t0:.1f} s (model build "
        f"included); launches {counts} ({smi})")
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"example losses {losses}")
    if counts != {"K1-lse": 3 * (LAYERS - 1), "K2": 3 * (LAYERS - 1)}:
        raise AssertionError(f"example launches {counts}")


def ms448_config(**overrides):
    """`benchmarks/bench_multistate.py`'s `i448:shared1024/256` case: ViT-B/8
    @448 (3136 patch tokens + 2 x 16 TX/RX slots = 3168), clustering at
    layers 4, 6, 8 and 10 with shared-anchor NCut."""
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig

    cfg = MultiStateViTConfig(
        patch_size=8, image_size=448, pregeneration_period=4, generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8, num_sample=1024, max_clusters=MS_CLUSTERS,
            eigenvalue_threshold=0.1, ncut_dist="rbf", eig_method="subspace",
            shared_anchors=True, anchors_per_parent=256))
    return dataclasses.replace(cfg, **overrides)


def _attn_counts() -> dict:
    """Launch counts of the multistate serving kernels."""
    from msvit_tpu_torch.ops.banded_attention import token_rows
    from msvit_tpu_torch.ops.flash_attention import flash_attention
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked

    return {**_fused_counts(), "K7": flash_attention.launches,
            "K9": packed_attention_int8_masked.launches, "K10": token_rows.launches}


def _reset_attn_counts() -> None:
    from msvit_tpu_torch.ops.banded_attention import token_rows
    from msvit_tpu_torch.ops.flash_attention import flash_attention
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked

    _reset_fused_counts()
    flash_attention.launches = 0
    packed_attention_int8_masked.launches = 0
    token_rows.launches = 0


def _launched(label: str, want: dict) -> None:
    """Fail unless the counts since the last reset are `want` (kernels not
    named: 0)."""
    got = _attn_counts()
    full = {k: want.get(k, 0) for k in got}
    log(f"[{label}] launches per forward {got}")
    if got != full:
        raise AssertionError(f"{label}: launches {got}, want {full}")


def _syncs(fn) -> int:
    """Host synchronizations during one call of `fn`."""
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _agree(a: dict, b: dict) -> float:
    """Min per-image cosine of the patch tokens and of TX_0."""
    return min(min_cos(a["last_hidden_state"], b["last_hidden_state"]),
               min_cos(a["cluster_tokens"][:, :1], b["cluster_tokens"][:, :1]))


def _purity(a: torch.Tensor, b: torch.Tensor) -> float:
    """Agreement of two partitions whatever their labels: the share of
    tokens in the best-matching cluster, each way, the smaller (1.0 when the
    partitions are equal up to relabelling)."""
    c = int(max(a.max(), b.max())) + 1
    cont = torch.bincount((a * c + b).flatten(), minlength=c * c).reshape(c, c)
    return min(cont.amax(1).sum().item(), cont.amax(0).sum().item()) / a.numel()


def _sizes(out: dict) -> list:
    return torch.bincount(out["last_cluster_indices"].flatten(), minlength=MS_CLUSTERS).tolist()


def ms448_phase(dev, smi: str) -> tuple:
    """Multistate serving at 448 px (3168 tokens), seeded weights and the
    seeded scene at 448: without clustering events the bf16 and int8
    forwards (K7 in 11 layers) against the plain attention path; with them
    valid outputs, K7 launched 11 times per forward of each and K4, K5 not
    at all; ms/batch, img/s, peak memory, host syncs, clusters.  Then the
    banded mode (K10, 11 launches) against the dense forward, the same
    weights and draws: in bf16 the partitions' agreement and the
    patch-token cosine, in f32 equal partitions and the cosine.  Returns
    (launches, the bf16 run's partition)."""
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales,
        quantize_multistate_params, quantized_multistate_apply)
    from msvit_tpu_torch.settings import parity_policy
    from msvit_tpu_torch.utils.rng import Rng

    t0 = time.perf_counter()
    cfg = ms448_config()
    flat = ms448_config(pregeneration_period=LAYERS)
    model = MultiStateViTEncoderModel(
        cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    state = model.state_dict()

    def twin(c):
        m = MultiStateViTEncoderModel(c, device=dev).eval()
        m.load_state_dict(state)
        return m

    qparams = quantize_multistate_params(model)
    scales = calibrate_multistate_act_scales(qparams, cfg, scene_pixels(1, size=448).to(dev),
                                             Rng(0))
    # seed 5: seed 2's scene at 448 keeps one cluster under shared anchors
    # (the first event's eigenvalues stay under the threshold), seed 5's
    # splits (9 clusters; NVIDIA H100 80GB HBM3, 700 W)
    pix = scene_pixels(5, size=448).to(dev)
    torch.cuda.synchronize()
    log(f"[ms448] ViT-B/8 multistate encoder at 448 px (3136 patch tokens, 3168 with "
        f"the TX/RX slots) built, quantized, calibrated on 8 seeded scene images in "
        f"{time.perf_counter() - t0:.1f} s")

    def int8(c, use_kernels=None):
        return quantized_multistate_apply(qparams, c, pix, Rng(3), act_scales=scales,
                                          use_kernels=use_kernels)

    def bf16(m):
        with torch.inference_mode():
            return m(pix, rng=Rng(3))

    with torch.inference_mode():
        n2 = model(scene_pixels(2, size=448).to(dev), rng=Rng(3))["num_clusters"]
    log(f"[ms448] seed 2's scene at 448 px: num_clusters {int(n2)} (seed 5's is served)")
    flat_k = twin(flat)
    _reset_attn_counts()
    bk = bf16(flat_k)
    _launched("ms448 bf16, no clustering event", {"K7": LAYERS - 1})
    bp = bf16(twin(dataclasses.replace(flat, attn_implementation="xla")))
    c_bf16 = _agree(bk, bp)
    del bk, bp, flat_k
    _reset_attn_counts()
    ik = int8(flat)
    _launched("ms448 int8, no clustering event", {"K7": LAYERS - 1})
    ip = int8(flat, use_kernels=False)
    c_int8 = _agree(ik, ip)
    del ik, ip
    torch.cuda.empty_cache()
    log(f"[ms448] no clustering event, min per-image cosine: bf16 kernel path (K7) vs "
        f"plain path {c_bf16!r} (tolerance >= {MS_BF16_COS!r}); int8 kernel path vs plain "
        f"path {c_int8!r} (tolerance >= {MS_INT8_COS!r})")
    if c_bf16 < MS_BF16_COS or c_int8 < MS_INT8_COS:
        raise AssertionError("448-px kernel path disagrees with the plain path")

    _reset_attn_counts()
    ci = int8(cfg)
    _launched("ms448 int8 with clustering", {"K7": LAYERS - 1})
    _reset_attn_counts()
    cb = bf16(model)
    _launched("ms448 bf16 with clustering", {"K7": LAYERS - 1})
    launches = {"K7": _attn_counts()["K7"]}
    _check_multistate_out("ms448 int8", ci, cfg)
    _check_multistate_out("ms448 bf16", cb, cfg)
    for label, out in (("int8", ci), ("bf16", cb)):
        log(f"[ms448] {label} with clustering: num_clusters {int(out['num_clusters'])}, "
            f"cluster sizes {_sizes(out)}")
    partition = (cb["last_cluster_indices"], cb["num_clusters"])
    del ci
    torch.cuda.empty_cache()

    # banded: the same weights and draws, tokens kept cluster-sorted (K10)
    banded = twin(dataclasses.replace(cfg, banded_attention=True))
    _reset_attn_counts()
    cd = bf16(banded)
    _launched("ms448 banded bf16 with clustering", {"K10": LAYERS - 1})
    launches["K10"] = _attn_counts()["K10"]
    _check_multistate_out("ms448 banded", cd, cfg)
    cx = bf16(twin(dataclasses.replace(cfg, attn_implementation="xla")))
    ids_b, ids_d, ids_x = (o["last_cluster_indices"] for o in (cd, cb, cx))
    p_band, p_plain = _purity(ids_b, ids_d), _purity(ids_x, ids_d)
    c_band = min_cos(cd["last_hidden_state"], cb["last_hidden_state"])
    log(f"[ms448] banded vs dense bf16 forward, the same weights and draws: num_clusters "
        f"{int(cd['num_clusters'])} vs {int(cb['num_clusters'])}, partitions equal "
        f"{torch.equal(ids_b, ids_d)}, agreement (purity) {p_band!r} (tolerance >= "
        f"{MS_PARTITION_PURITY!r}; the plain attention path vs the dense kernel path "
        f"{p_plain!r}: the later events split near-identical tokens, which bf16 rounding "
        f"moves whatever the kernel); min per-image patch-token cosine {c_band!r} "
        f"(tolerance >= {MS_BF16_COS!r})")
    if p_band < MS_PARTITION_PURITY or c_band < MS_BF16_COS:
        raise AssertionError("448-px banded forward disagrees with the dense forward")
    del cd, cx
    # the same in f32 (parity policy), where rounding moves no token
    f32 = dataclasses.replace(cfg, policy=parity_policy())
    _reset_attn_counts()
    d32 = bf16(twin(f32))
    b32 = bf16(twin(dataclasses.replace(f32, banded_attention=True)))
    _launched("ms448 f32 dense + banded", {"K7": LAYERS - 1, "K10": LAYERS - 1})
    same = torch.equal(d32["last_cluster_indices"], b32["last_cluster_indices"])
    c32 = min_cos(d32["last_hidden_state"], b32["last_hidden_state"])
    log(f"[ms448] banded vs dense forward in f32 (parity policy, tf32 off), the same "
        f"weights and draws: num_clusters {int(b32['num_clusters'])} vs "
        f"{int(d32['num_clusters'])}, partitions equal {same}; min per-image patch-token "
        f"cosine {c32!r} (tolerance >= {MS_BF16_COS!r})")
    if not same or c32 < MS_BF16_COS:
        raise AssertionError("448-px banded forward (f32) disagrees with the dense forward")
    del cb, d32, b32
    torch.cuda.empty_cache()

    rows = []
    for label, fn in (("int8", lambda: int8(cfg)), ("bf16", lambda: bf16(model)),
                      ("banded bf16", lambda: bf16(banded))):
        ms = wall_ms(fn, runs=3, warmup=1)
        syncs, peak = _syncs(fn), _peak_gib(fn)
        rows.append(f"{label} {ms!r} ms/batch ({MS_BATCH / ms * 1e3!r} img/s, peak "
                    f"{peak!r} GiB, host syncs {syncs})")
    log(f"[ms448] forward bs8 with clustering: {'; '.join(rows)} (3 runs after 1 of "
        f"warm-up, host clock; peak memory with the bf16 and int8 weights resident; {smi})")
    return launches, partition


def ms224_attn_modes_phase(dev, smi: str) -> dict:
    """The int8 apply at `bench.py`'s 224-px config in its other attention
    modes: "int8" (K9, calibrated scales) and "banded" (K10), each against
    `attn_mode="bf16"` (K4) with the same weights and draws: without
    clustering events the outputs' cosine; with them valid outputs, 11
    launches per forward, the partition's agreement, ms/batch."""
    cfg, run = ms224_int8(dev)
    flat = multistate_config(pregeneration_period=LAYERS)
    ref_flat, ref = run(flat, "bf16"), run(cfg, "bf16")
    launches = {}
    for mode, k in (("int8", "K9"), ("banded", "K10")):
        _reset_attn_counts()
        f = run(flat, mode)
        _launched(f"ms224 {mode}, no clustering event", {k: LAYERS - 1})
        _reset_attn_counts()
        out = run(cfg, mode)
        _launched(f"ms224 {mode} with clustering", {k: LAYERS - 1})
        launches[k] = _attn_counts()[k]
        _check_multistate_out(f"ms224 {mode}", out, cfg)
        c_flat = _agree(f, ref_flat)
        same = _purity(out["last_cluster_indices"], ref["last_cluster_indices"])
        ms = wall_ms(lambda: run(cfg, mode), runs=5)
        tol = MS_INT8_ATTN_COS if mode == "int8" else MS_INT8_COS
        log(f"[ms224] attn_mode={mode!r} vs 'bf16': no clustering event, min per-image "
            f"cosine {c_flat!r} (tolerance >= {tol!r}); with clustering, num_clusters "
            f"{int(out['num_clusters'])} vs {int(ref['num_clusters'])}, partition agreement "
            f"(purity) {same!r}; {ms!r} ms/batch "
            f"({MS_BATCH / ms * 1e3!r} img/s; 5 runs after 2 of warm-up, host clock; {smi})")
        if c_flat < tol:
            raise AssertionError(f"attn_mode={mode!r} disagrees with 'bf16'")
    total, k9 = ms224_int8_profile(cfg, run)
    log(f"[ms224] device time per attn_mode='int8' forward with clustering (every kernel, "
        f"copy and set summed, torch.profiler, 3 forwards after 1 of warm-up): {total!r} ms, "
        f"K9 {k9!r} ms, {k9 / total!r} of it ({smi})")
    return launches


def ms224_int8(dev) -> tuple:
    """The multistate encoder at `bench.py`'s 224-px config drawn from seed
    0 (multistate_phase's weights), its int8 weights and scales calibrated
    on scene 1: (cfg, run), run(c, mode) the int8 apply on scene 2 under
    config c and `attn_mode` mode, clustering draws from Rng(3)."""
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales,
        quantize_multistate_params, quantized_multistate_apply)
    from msvit_tpu_torch.utils.rng import Rng

    cfg = multistate_config()
    model = MultiStateViTEncoderModel(
        cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    qparams = quantize_multistate_params(model)
    scales = calibrate_multistate_act_scales(qparams, cfg, scene_pixels(1).to(dev), Rng(0))
    pix = scene_pixels(2).to(dev)

    def run(c, mode):
        return quantized_multistate_apply(qparams, c, pix, Rng(3), act_scales=scales,
                                          attn_mode=mode)

    return cfg, run


def ms224_int8_profile(cfg, run) -> tuple:
    """Device time per attn_mode="int8" forward with clustering and the
    part of it in K9 (`device_profile`)."""
    return device_profile(lambda: run(cfg, "int8"), "packed_attention_int8_kernel",
                          LAYERS - 1)


def _soft(ids, n_clusters):
    from msvit_tpu_torch.models.multistate import build_multistate_attention_mask

    return torch.where(build_multistate_attention_mask(ids, n_clusters, MS_CLUSTERS),
                       0.0, -100.0)  # [8, 1, S, S] f32


def _check(tag: str, label: str, err: float, tol: float) -> float:
    log(f"[{tag}] {label}: max_abs_err {err!r} (tolerance {tol!r}) "
        f"{'ok' if err <= tol else 'FAILED'}")
    if err > tol:
        raise AssertionError(f"{tag} {label}: error {err} > {tol}")
    return err


def flash_kernel_phase(dev, smi: str, partition) -> dict:
    """K7 and K7-lse against their plain versions at [8,12,3168,64] on q/k/v
    views of a packed QKV output with the 448-px partition's soft mask (also
    f32, a bool mask with a fully masked row, Nq 197 x Nk 3168), the lse;
    `FlashAttentionFunction`'s gradients against the plain Function
    (K7-lse + K6 vs plain, [2,12,3168,64]); then K7 timed."""
    from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
    from msvit_tpu_torch.ops.flash_attention import (
        FlashAttentionFunction, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_lse, flash_attention_lse_plain,
        flash_attention_plain)
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, h, n, dh = MS448_SHAPE
    gen = torch.Generator().manual_seed(10)
    soft = _soft(*partition)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(dev)
    qf, kf, vf = unpack_qkv(x, h)
    q, k, v = unpack_qkv(x.to(torch.bfloat16), h)
    mb = torch.rand(b, 1, n, n, generator=gen) < 0.7
    mb[0, 0, 5, :] = False  # one fully masked row: mean(V)
    mb = mb.to(dev)
    shape = list(MS448_SHAPE)
    cases = [
        (f"bf16 {shape} soft mask of the 448 partition", (q, k, v), soft),
        (f"f32 {shape} soft mask (tf32 off)", (qf, kf, vf), soft),
        (f"bf16 {shape} bool mask, one row fully masked", (q, k, v), mb),
        ("bf16 Nq 197 x Nk 3168, soft mask", (q[:, :, :197], k, v), soft[:, :, :197]),
    ]
    errs = []
    with torch.inference_mode():
        for label, (qq, kk, vv), m in cases:
            o, lse = flash_attention_lse(qq, kk, vv, mask=m)
            wo, wl = flash_attention_lse_plain(qq, kk, vv, mask=m)
            got = flash_attention(qq, kk, vv, mask=m)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.equal(got, o)):
                raise AssertionError(f"K7 {label}: non-finite, or K7 != K7-lse's out")
            tol = K1_TOL[qq.dtype] * max(1.0, wo.float().abs().max().item())
            errs.append(_check("flash-kernels", f"K7 {label}", max_err(got, wo), tol))
            e_l = ((lse - wl).abs() / wl.abs().clamp_min(1.0)).max().item()
            _check("flash-kernels", f"K7-lse {label} lse (relative)", e_l, LSE_REL_TOL)
            del o, lse, wo, wl, got
        torch.cuda.empty_cache()
        ms, plain_ms = race(lambda: flash_attention(q, k, v, mask=soft),
                            lambda: flash_attention_plain(q, k, v, mask=soft))
        lib = library_ms(lambda: sdpa(q, k, v, soft))
    # the Function's gradients (K7-lse forward, K6 backward) against the
    # plain versions of both on the same residuals' recipe
    xd = x[:2].to(torch.bfloat16).requires_grad_()
    qq, kk, vv = unpack_qkv(xd, h)
    g = torch.randn(2, h, n, dh, generator=gen).to(dev).to(torch.bfloat16)
    FlashAttentionFunction.apply(qq, kk, vv, soft[:2], dh**-0.5, DEFAULT_MASK_VALUE).backward(g)
    torch.cuda.synchronize()
    with torch.no_grad():
        wo, wl = flash_attention_lse_plain(qq, kk, vv, mask=soft[:2])
        want = flash_attention_bwd_plain(qq, kk, vv, wo, g, wl, soft[:2])
    got = unpack_qkv(xd.grad, h)
    e_g = max(max_err(a, w) for a, w in zip(got, want))
    tol_g = K6_TOL[torch.bfloat16] * max(1.0, max(w.float().abs().max().item() for w in want))
    _check("flash-kernels", "FlashAttentionFunction bf16 [2,12,3168,64] soft mask: dq, dk, "
           "dv vs the plain K7-lse and K6", e_g, tol_g)
    del xd, g, wo, wl, want, got
    ops = attn_ops(b, h, n, n, dh, 2)
    lim = bound([q, k, v, soft], [q], ops, torch.bfloat16)
    log(f"[flash-kernels] K7 bf16 {shape} soft mask: kernel {ms!r} ms, plain {plain_ms!r} "
        f"ms, library (scaled_dot_product_attention, the mask in bf16) {lib!r} ms, bound "
        f"{lim}; {rate(ops, ms, lim)} (median of 20, CUDA events; {smi})")
    res = {"K7": dict(err=errs[0], ms=ms, plain_ms=plain_ms, library_ms=lib, **lim)}
    # K6 at this shape, FlashAttentionFunction's backward: against plain, timed
    g = torch.randn(b, n, h, dh, generator=gen).to(dev).to(torch.bfloat16).transpose(1, 2)
    with torch.no_grad():
        wo, wl = flash_attention_lse_plain(q, k, v, mask=soft)
        got = flash_attention_bwd(q, k, v, wo, g, wl, soft)
        want = flash_attention_bwd_plain(q, k, v, wo, g, wl, soft)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError("K6 at 3168: non-finite output")
        tol = K6_TOL[torch.bfloat16] * max(1.0, max(w.float().abs().max().item() for w in want))
        e6 = _check("flash-kernels", f"K6 bf16 {shape} soft mask: dq, dk, dv",
                    max(max_err(a, w) for a, w in zip(got, want)), tol)
        del got, want
        torch.cuda.empty_cache()
        b_ms, b_plain = race(lambda: flash_attention_bwd(q, k, v, wo, g, wl, soft),
                             lambda: flash_attention_bwd_plain(q, k, v, wo, g, wl, soft))
        b_lib = library_ms(sdpa_bwd(q, k, v, g, soft))
    torch.cuda.synchronize()
    b_ops = attn_ops(b, h, n, n, dh, 5)
    b_lim = bound([q, k, v, wo, g, wl, soft], [q, k, v], b_ops, torch.bfloat16)
    log(f"[flash-kernels] K6 bf16 {shape} soft mask: kernel {b_ms!r} ms, plain {b_plain!r} "
        f"ms, library (the backward of scaled_dot_product_attention) {b_lib!r} ms, bound "
        f"{b_lim}; {rate(b_ops, b_ms, b_lim)} (5 products; median of 20, CUDA events; "
        f"{smi})")
    res["K6@3168"] = dict(err=e6, ms=b_ms, plain_ms=b_plain, library_ms=b_lib, **b_lim)
    return res


def banded_kernel_phase(dev, smi: str, part448, part224) -> dict:
    """K10 against its plain version on the token rows of each partition
    (sorted by cluster id, a stable sort): [8, 32+3136, 2304] at 448 px (and
    one cluster, the band of the layers before the first event) and
    [8, 32+784, 2304] at 224, bf16 (f32 at 224 too); then timed.  Its work
    depends on the partition: the bound counts the pairs of tokens in one
    cluster plus each token's RX key, the work this data needs (the band's
    tiles and the dense N x S are logged as upper bounds)."""
    from msvit_tpu_torch.ops.banded_attention import (
        BAND_KEYS, BAND_ROWS, band_limits, token_rows, token_rows_plain)

    h, dh = 12, 64
    pfx = 2 * MS_CLUSTERS
    gen = torch.Generator().manual_seed(11)
    res = {}
    one = torch.zeros_like(part448[0])  # the layers before the first event
    for tag, (ids, _) in (("448", part448), ("224", part224),
                          ("448 one-cluster", (one, None))):
        cid = torch.sort(ids, dim=1, stable=True).values
        b, n = cid.shape
        x = (torch.randn(b, pfx + n, 3 * h * dh, generator=gen) * 0.5).to(dev)
        x[..., :h * dh] *= dh**-0.5  # the q third pre-scaled
        xb = x.to(torch.bfloat16)
        shape = f"[{b}, {pfx}+{n}, {3 * h * dh}]"
        cases = [(f"bf16 {shape}, the {tag} partition", xb)]
        if tag == "224":
            cases.append((f"f32 {shape}, the {tag} partition (tf32 off)", x))
        with torch.inference_mode():
            for label, xx in cases:
                got = token_rows(xx, cid, h, MS_CLUSTERS)
                want = token_rows_plain(xx, cid, h, MS_CLUSTERS)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"K10 {label}: non-finite output")
                tol = K1_TOL[xx.dtype] * max(1.0, want.float().abs().max().item())
                err = _check("banded-kernels", f"K10 {label}", max_err(got, want), tol)
                if xx is xb:
                    e_bf16 = err
                del got, want
            torch.cuda.empty_cache()
            ms, plain_ms = race(lambda: token_rows(xb, cid, h, MS_CLUSTERS),
                                lambda: token_rows_plain(xb, cid, h, MS_CLUSTERS))
            alone = device_ms(lambda: token_rows(xb, cid, h, MS_CLUSTERS), "banded_mma_kernel")
            # the library yardstick: SDPA over the token rows' queries and
            # every key, the equivalent mask (own cluster, own RX) in bf16
            cols = torch.arange(pfx + n, device=dev)
            key_cid = F.pad(cid, (pfx, 0), value=-1)
            keep = (cols[None, None] == 2 * cid[:, :, None] + 1) | (
                (cols[None, None] >= pfx) & (cid[:, :, None] == key_cid[:, None, :]))
            add = torch.where(keep, 0.0, float("-inf")).to(torch.bfloat16)[:, None]
            t = xb.reshape(b, pfx + n, 3, h, dh).permute(2, 0, 3, 1, 4)
            lib = library_ms(lambda: F.scaled_dot_product_attention(
                t[0][:, :, pfx:], t[1], t[2], attn_mask=add, scale=1.0))
            del add, keep
        sizes = torch.stack([torch.bincount(r, minlength=MS_CLUSTERS) for r in cid]).double()
        pairs = (sizes**2).sum().item() + b * n  # same-cluster keys + the RX key
        band = band_limits(cid.to(torch.int32), MS_CLUSTERS)
        walked = ((band[:, 1] - band[:, 0] + 1).double() * BAND_ROWS * BAND_KEYS).sum().item()
        out = torch.empty(b, n, h * dh, dtype=torch.bfloat16, device=dev)
        lim = bound([xb, cid.to(torch.int32)], [out], 4.0 * h * dh * pairs, torch.bfloat16)
        log(f"[banded-kernels] K10 bf16 {shape} ({tag} partition, cluster sizes "
            f"{sizes.sum(0).long().tolist()}): kernel {ms!r} ms, plain {plain_ms!r} ms, "
            f"library (scaled_dot_product_attention, the equivalent mask in bf16) {lib!r} ms, "
            f"bound {lim} for the {pairs:.0f} query-key pairs this partition needs; "
            f"{rate(4.0 * h * dh * pairs, ms, lim)}; upper bounds: the band's tiles "
            f"{walked:.0f} pairs, dense {b * n * (pfx + n)} (median of 20, CUDA events; "
            f"{smi}); the kernel alone {alone!r} ms ({rate(4.0 * h * dh * pairs, alone, lim)}; "
            f"device time, torch.profiler), the rest the wrapper's band table and launch")
        res["K10" if tag == "448" else f"K10@{tag}"] = dict(
            err=e_bf16, ms=ms, plain_ms=plain_ms, library_ms=lib, kernel_alone_ms=alone,
            **lim)
    return res


def int8_attn_kernel_phase(dev, smi: str, partition) -> dict:
    """K9 against its plain version at [8,816,2304] (per-section quantized
    qkv) with the 224 partition's soft mask, bf16 and int8 out, also a bool
    mask with a fully masked row (mean(V)); the share bit-equal to plain;
    then the int8-out call timed, through the wrapper and alone, beside
    bf16 K4 at the same shape and mask; the kernel's blocks per SM."""
    from msvit_tpu_torch.ops.fused_attention import fused_attention_inference
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_int8_masked, packed_attention_int8_masked_plain, unpack_qkv)

    b, h, n, dh = MS_SHAPE
    d = h * dh
    gen = torch.Generator().manual_seed(12)
    soft = _soft(*partition)
    xf, q, sec = int8_qkv(gen, (b, n, 3 * d), dev)
    mb = torch.rand(b, 1, n, n, generator=gen) < 0.7
    mb[0, 0, 5, :] = False
    mb = mb.to(dev)
    with torch.inference_mode():
        for label, m in (("soft mask of the 224 partition", soft),
                         ("bool mask, one row fully masked", mb)):
            got = packed_attention_int8_masked(q, sec, h, mask=m)
            want = packed_attention_int8_masked_plain(q, sec, h, mask=m)
            e_b = _check("int8-attn-kernels", f"K9 int8 [8,816,2304] {label}, bf16 out",
                         max_err(got, want), K3_BF16_REL_TOL * want.float().abs().max().item())
            inv = 127.0 / want.float().abs().amax()
            gq = packed_attention_int8_masked(q, sec, h, mask=m, out_inv_scale=inv, int8_out=True)
            wq = packed_attention_int8_masked_plain(q, sec, h, mask=m, out_inv_scale=inv,
                                                    int8_out=True)
            delta = (gq.int() - wq.int()).abs()
            same = (delta == 0).float().mean().item()
            same_bf16 = (got == want).float().mean().item()
            log(f"[int8-attn-kernels] K9 int8 [8,816,2304] {label}, int8 out: max |delta| "
                f"{delta.max().item()} (tolerance 1), exactly equal {same!r} (tolerance >= "
                f"0.99); bf16 out bit-equal to plain on {same_bf16!r} of the elements")
            if delta.max().item() > 1 or same < 0.99:
                raise AssertionError("K9 int8 out disagrees with its plain version")
            if m is soft:
                err, args = e_b, (inv, gq, same)
            else:  # the fully masked row is mean(V): s_v times the mean of v
                mean = q[0, :, 2 * d:].float().mean(0) * sec[2]
                _check("int8-attn-kernels", "K9 bool mask: the fully masked row vs mean(V)",
                       max_err(got[0, 5], mean), K3_BF16_REL_TOL * want.float().abs().max().item())
        inv, gq, same = args
        ms, plain_ms = race(
            lambda: packed_attention_int8_masked(q, sec, h, mask=soft, out_inv_scale=inv,
                                                 int8_out=True),
            lambda: packed_attention_int8_masked_plain(q, sec, h, mask=soft,
                                                       out_inv_scale=inv, int8_out=True))
        alone = device_ms(lambda: packed_attention_int8_masked(
            q, sec, h, mask=soft, out_inv_scale=inv, int8_out=True), "packed_attention_int8_kernel")
        # the yardstick: bf16 K4 on the same shape and mask, from this run
        qb, kb, vb = unpack_qkv(xf.to(torch.bfloat16), h)
        k4_ms = statistics.median(time_ms(
            lambda: fused_attention_inference(qb, kb, vb, mask=soft), runs=20))
        k4_alone = device_ms(lambda: fused_attention_inference(qb, kb, vb, mask=soft),
                             "flash_mma_kernel")
    torch.cuda.synchronize()
    # the additive mask rides bf16, as the kernel reads it
    ops = attn_ops(b, h, n, n, dh, 2)
    lim = bound([q, sec, soft.to(torch.bfloat16)], [gq], ops, torch.int8)
    log(f"[int8-attn-kernels] K9 int8-out [8,816,2304] soft mask: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, no library call, bound {lim}; {rate(ops, ms, lim)} (median of 20, "
        f"CUDA events; {smi}); the kernel alone {alone!r} ms (device time, torch.profiler; "
        f"{rate(ops, alone, lim)}; q.k twice: {1.5 * ops / alone / 1e9!r} TOP/s executed); "
        f"yardstick K4 bf16 [8,12,816,64] with the same mask {k4_ms!r} ms, alone "
        f"{k4_alone!r} ms")
    log(f"[int8-attn-kernels] {int8_occupancy(dh, (b, h, n), masked=True)} ({smi})")
    return {"K9": dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       kernel_alone_ms=alone, bit_equal=same, **lim)}


GROUPED_SHAPE = (64, 785, 2304)  # ViT-B/8 @224 pretrain: 784 patch tokens + CLS, bs64


def _packed_counts() -> dict:
    from msvit_tpu_torch.ops.packed_attention import packed_attention

    return {"K1": packed_attention.launches, **_training_counts()}


def _reset_packed_counts() -> None:
    from msvit_tpu_torch.ops.packed_attention import packed_attention

    packed_attention.launches = 0
    _reset_training_counts()


def grouped_kernel_phase(dev, smi: str, partition) -> dict:
    """K1, K1-lse and K2 at the shapes of the TPU's head-grouped functions
    (K8a `_packed_forward_grouped`, K8b `_packed_backward_grouped`), which
    they stand for: bf16 [64,785,2304] (the ViT-B/8 pretrain), f32
    [16,785,2304], bf16 [8,816,2304] with the served partition's soft mask,
    masked f32 [64,197,2304] (a per-head additive mask), large logits; then
    each timed at [64,785,2304] beside `scaled_dot_product_attention` (or its
    backward) and its bound."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_bwd, packed_attention_bwd_plain,
        packed_attention_lse, packed_attention_lse_plain, packed_attention_plain,
        unpack_qkv)

    tag = "grouped-kernels"
    g = torch.Generator().manual_seed(13)

    def case(label, x, mask=None):
        with torch.inference_mode():
            e = _check(tag, f"K1 {label}",
                       max_err(packed_attention(x, 12, mask=mask),
                               packed_attention_plain(x, 12, mask=mask)), K1_TOL[x.dtype])
        return (e, *_lse_bwd_case(tag, g, label, x, mask))

    b, n, d3 = GROUPED_SHAPE
    x = torch.randn(GROUPED_SHAPE, generator=g).to(torch.bfloat16).to(dev)
    e_k1, e_fwd, e_bwd, (x, gr, wo, wl) = case(f"bf16 {list(GROUPED_SHAPE)}", x)
    case("f32 [16,785,2304] (tf32 off)", torch.randn(16, n, d3, generator=g).to(dev))
    case("bf16 [8,816,2304] soft mask of the served partition",
         torch.randn(8, 816, d3, generator=g).to(torch.bfloat16).to(dev), _soft(*partition))
    ma = -100.0 * (torch.rand(64, 12, 197, 197, generator=g) < 0.3).float()
    case("f32 [64,197,2304] additive mask [64,12,197,197] (tf32 off)",
         torch.randn(MAIN_SHAPE, generator=g).to(dev), ma.to(dev))
    del ma
    big = torch.randn(4, n, d3, generator=g).to(dev)
    big[..., :1536] *= 12.0  # q and k: logits in the hundreds
    q, k, _ = unpack_qkv(big, 12)
    s_max = (torch.matmul(q, k.transpose(-1, -2)) * 0.125).abs().max().item()
    if s_max <= 150:
        raise AssertionError(f"large-logit case: max |s| {s_max} <= 150")
    # K1 clamps such logits by contract; the training pair stays exact
    _lse_bwd_case(tag, g, f"f32 [4,785,2304] large logits (max |s| {s_max:.1f})", big)
    del big, q, k
    torch.cuda.empty_cache()

    with torch.no_grad():
        k_ms, k_plain = race(lambda: packed_attention(x, 12),
                             lambda: packed_attention_plain(x, 12))
        f_ms, f_plain = race(lambda: packed_attention_lse(x, 12),
                             lambda: packed_attention_lse_plain(x, 12))
        b_ms, b_plain = race(lambda: packed_attention_bwd(x, None, wo, wl, gr, 12),
                             lambda: packed_attention_bwd_plain(x, None, wo, wl, gr, 12))
        qkv = unpack_qkv(x, 12)
        f_lib = library_ms(lambda: sdpa(*qkv))
        b_lib = library_ms(sdpa_bwd(*qkv, gr.reshape(b, n, 12, -1).transpose(1, 2)))
    torch.cuda.synchronize()
    dh = d3 // 36
    f_ops, b_ops = (attn_ops(b, 12, n, n, dh, k) for k in (2, 5))
    k_bound = bound([x], [wo], f_ops, torch.bfloat16)
    f_bound = bound([x], [wo, wl], f_ops, torch.bfloat16)
    b_bound = bound([x, wo, wl, gr], [x], b_ops, torch.bfloat16)
    shape = list(GROUPED_SHAPE)
    log(f"[{tag}] K1 (for K8a) bf16 {shape}: kernel {k_ms!r} ms, plain {k_plain!r} ms, "
        f"library (scaled_dot_product_attention) {f_lib!r} ms, bound {k_bound}; "
        f"{rate(f_ops, k_ms, k_bound)} (median of 20, CUDA events; {smi})")
    log(f"[{tag}] K1-lse (for K8a, with_lse) bf16 {shape}: kernel {f_ms!r} ms, plain "
        f"{f_plain!r} ms, library (scaled_dot_product_attention) {f_lib!r} ms, bound "
        f"{f_bound}; {rate(f_ops, f_ms, f_bound)} (median of 20, CUDA events; {smi})")
    log(f"[{tag}] K2 (for K8b) bf16 {shape}: kernel {b_ms!r} ms, plain {b_plain!r} ms, "
        f"library (its backward) {b_lib!r} ms, bound {b_bound}; "
        f"{rate(b_ops, b_ms, b_bound)} (median of 20, CUDA events; {smi})")
    return {"K8a": dict(err=e_k1, ms=k_ms, plain_ms=k_plain, library_ms=f_lib, **k_bound),
            "K8a-lse": dict(err=e_fwd, ms=f_ms, plain_ms=f_plain, library_ms=f_lib, **f_bound),
            "K8b": dict(err=e_bwd, ms=b_ms, plain_ms=b_plain, library_ms=b_lib, **b_bound)}


def _pretrain_args(out: str, *extra):
    from msvit_tpu_torch.examples import pretrain_synthetic

    return pretrain_synthetic.build_parser().parse_args(
        ["--preset", "b8", "--batch", "64", "--clip", "1.0", "--out", out, *extra])


def _metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def pretrain_phase(dev, smi: str, out: str) -> tuple:
    """`pretrain_synthetic.pretrain` at `--preset b8` (ViT-B/8 @224, 785
    tokens, full width and depth) for 10 steps at bs64 with the clip at 1.0,
    on 256 scenes made in memory by `generate_batch`: finite, falling loss,
    K1-lse and K2 launched 12 times a step and K1 12 times per eval batch,
    the checkpoint and summary written.  Then the step timed through
    `Trainer` with the example's loss: fed by `prefetch_to_device`, with the
    same batches already on the device, and fed by blocking copies; peak
    memory and host syncs.  Returns (launches, the checkpoint's directory)."""
    import contextlib
    import importlib.util

    from msvit_tpu_torch.data.pipeline import prefetch_to_device
    from msvit_tpu_torch.data.synthetic import corpus_batches, generate_batch
    from msvit_tpu_torch.examples import pretrain_synthetic as ps
    from msvit_tpu_torch.models.base import ViTForImageClassification
    from msvit_tpu_torch.train import Trainer, make_optimizer

    t0 = time.perf_counter()
    data = generate_batch(range(256), size=224)
    log(f"[pretrain] 256 scenes at 224 px made in memory by generate_batch in "
        f"{time.perf_counter() - t0:.1f} s (PIL importable: "
        f"{importlib.util.find_spec('PIL') is not None}; the JPEG corpus path is not "
        f"taken here); labels {np.bincount(data['labels'], minlength=5).tolist()}")
    steps, eval_size = 10, 128
    args = _pretrain_args(out, "--steps", str(steps), "--eval-size", str(eval_size))
    _reset_packed_counts()
    t0 = time.perf_counter()
    summary = ps.pretrain(args, data, log_every=1)
    wall = time.perf_counter() - t0
    launches = _packed_counts()
    run_dir = os.path.join(out, ps.run_name(args))
    rec = _metrics(run_dir)
    losses, norms = [r["loss"] for r in rec], [r["grad_norm"] for r in rec]
    log(f"[pretrain] ViT-B/8 pretrain, {steps} steps at bs64 + eval of {eval_size} in "
        f"{wall:.1f} s (model build included): losses {losses}; unclipped grad norms "
        f"{norms} ({sum(v > args.clip for v in norms)} steps clipped at {args.clip}); "
        f"held-out top-1 {summary['holdout_top1']!r}; launches {launches} ({smi})")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError("pretrain: a loss or a gradient norm is missing or not finite")
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        raise AssertionError("pretrain: the loss did not fall (last 3 steps vs first 3)")
    if not all(r["grads_finite"] == 1.0 for r in rec):
        raise AssertionError("pretrain: a step had non-finite gradients")
    want = {"K1": LAYERS * (eval_size // 64), "K1-lse": steps * LAYERS, "K2": steps * LAYERS}
    if launches != want:
        raise AssertionError(f"pretrain launches {launches}, want {want}")
    ckpt = os.path.join(run_dir, "ckpt")
    if not (os.path.isfile(os.path.join(run_dir, "summary.json"))
            and os.path.isfile(os.path.join(ckpt, f"ckpt_{steps}.pt"))):
        raise AssertionError("pretrain: summary.json or the checkpoint is missing")

    # the step through Trainer with the example's loss, three feeds
    model = ViTForImageClassification(
        ps.model_config(args), 5, generator=torch.Generator().manual_seed(0), device=dev)
    opt = make_optimizer(ps.warmup_cosine(args.lr, 1, 1000), weight_decay=args.weight_decay,
                         clip_norm=args.clip)
    tr = Trainer(ps.loss_fn, opt, model.train(), monitor=True, log_every=10**6)

    def host():
        return corpus_batches(data, 64, seed=1, uint8=True)

    def blocking():
        for bt in host():
            yield {k: torch.from_numpy(v).to(dev) for k, v in bt.items()}

    resident = [{k: torch.from_numpy(v).to(dev) for k, v in bt.items()}
                for bt in itertools.islice(host(), 4)]

    def timed(batches, n=5) -> float:
        tr.fit(batches, num_steps=tr.step + 2, seed=0)  # warm-up, ends in a loss read
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit(batches, num_steps=tr.step + n, seed=0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    torch.cuda.reset_peak_memory_stats()
    t_dev = timed(itertools.cycle(resident))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with contextlib.closing(prefetch_to_device(host(), device=dev)) as fed:
        t_pre = timed(fed)
        syncs = _syncs(lambda: tr.fit(fed, num_steps=tr.step + 3, seed=0))
    t_blk = timed(blocking())
    hidden = (t_blk - t_pre) / (t_blk - t_dev) if t_blk > t_dev else float("nan")
    log(f"[pretrain] ViT-B/8 train step bs64 through Trainer (the example's loss, clip "
        f"{args.clip}, non-finite skip on): batches resident on the device {t_dev!r} "
        f"ms/step ({64 / t_dev * 1e3!r} img/s), fed by prefetch_to_device {t_pre!r} ms/step "
        f"({64 / t_pre * 1e3!r} img/s), fed by blocking copies {t_blk!r} ms/step; share of "
        f"the feed's cost that the prefetch hides {hidden!r}; peak memory {peak!r} GiB; "
        f"host syncs in 3 steps fed by prefetch {syncs} (the last step's loss read "
        f"included; 5 steps after 2 of warm-up, host clock; {smi})")
    return {"K8a": launches["K1"], "K8a-lse": launches["K1-lse"], "K8b": launches["K2"]}, ckpt


def pretrain_variants_phase(dev, smi: str, out: str) -> None:
    """3 steps of the example with `--qk-norm` (b8) and 3 with `--dtype f32
    --preset b16`; the qk-norm model's loss and gradients on the kernel path
    against the plain attention path (the example's loss, bs16, the same
    weights and draws); a clipped step leaves gradients of the clip's norm."""
    from msvit_tpu_torch.data.synthetic import generate_batch
    from msvit_tpu_torch.examples import pretrain_synthetic as ps
    from msvit_tpu_torch.models.base import ViTForImageClassification
    from msvit_tpu_torch.train import make_optimizer, train_step_fn

    data = generate_batch(range(1000, 1128), size=224)
    for label, extra in (("--qk-norm", ["--qk-norm"]),
                         ("--dtype f32 --preset b16", ["--dtype", "f32", "--preset", "b16"])):
        args = _pretrain_args(os.path.join(out, "variants"), "--steps", "3", "--eval-size",
                              "64", *extra)
        _reset_packed_counts()
        t0 = time.perf_counter()
        ps.pretrain(args, data, log_every=1)
        counts = _packed_counts()
        rec = _metrics(os.path.join(out, "variants", ps.run_name(args)))[-3:]
        log(f"[pretrain-variants] {label}: 3 steps + eval of 64 in "
            f"{time.perf_counter() - t0:.1f} s; losses {[r['loss'] for r in rec]}; grad "
            f"norms {[r['grad_norm'] for r in rec]}; launches {counts} ({smi})")
        if not all(math.isfinite(r["loss"]) and r["grads_finite"] == 1.0 for r in rec):
            raise AssertionError(f"pretrain {label}: non-finite loss or gradients")
        if counts != {"K1": LAYERS, "K1-lse": 3 * LAYERS, "K2": 3 * LAYERS}:
            raise AssertionError(f"pretrain {label}: launches {counts}")
        torch.cuda.empty_cache()

    args = _pretrain_args(out, "--qk-norm")
    cfg = ps.model_config(args)
    batch = {"pixel_values": torch.from_numpy(data["images"][:16]).to(dev),
             "labels": torch.from_numpy(data["labels"][:16]).to(dev)}
    runs = {}
    for path in ("kernel", "plain"):
        c = cfg if path == "kernel" else dataclasses.replace(cfg, attn_implementation="xla")
        model = ViTForImageClassification(
            c, 5, generator=torch.Generator().manual_seed(0), device=dev).train()
        _reset_packed_counts()
        loss, _ = ps.loss_fn(model, batch, torch.Generator().manual_seed(7))
        loss.backward()
        runs[path] = (loss.item(), _packed_counts(),
                      torch.cat([p.grad.float().flatten() for p in model.parameters()]))
        if path == "plain":
            del model
    (lk, nk, gk), (lp, np_, gp) = runs["kernel"], runs["plain"]
    rel, c = abs(lk - lp) / abs(lp), cos(gk, gp)
    log(f"[pretrain-variants] ViT-B/8 --qk-norm classifier bs16, the example's loss: "
        f"kernel path {lk!r}, plain attention path {lp!r}, relative difference {rel!r} "
        f"(tolerance {GRAD_LOSS_REL_TOL!r}); cosine of the gradients {c!r} (tolerance >= "
        f"{GRAD_COS_TOL!r}); launches kernel path {nk}, plain path {np_}")
    if nk != {"K1": 0, "K1-lse": LAYERS, "K2": LAYERS} or any(np_.values()):
        raise AssertionError(f"launches kernel path {nk}, plain path {np_}")
    if not (rel <= GRAD_LOSS_REL_TOL and c >= GRAD_COS_TOL):
        raise AssertionError("qk-norm kernel-path gradients disagree with the plain path")
    del runs, gk, gp
    torch.cuda.empty_cache()

    # a clipped step: the gradients left on the parameters have the clip's norm
    model = ViTForImageClassification(
        cfg, 5, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = make_optimizer(1e-4, clip_norm=0.05)
    _, aux = train_step_fn(ps.loss_fn, opt, monitor=True)(
        model, opt.init(model), batch, torch.Generator().manual_seed(7))
    left = torch.linalg.vector_norm(torch.stack(
        [p.grad.float().norm() for p in model.parameters()])).item()
    norm = aux["grad_norm"].item()
    log(f"[pretrain-variants] clipped step: unclipped norm {norm!r}, clip 0.05, norm of "
        f"the gradients the update saw {left!r} (tolerance 1e-4 relative)")
    if not (norm > 0.05 and abs(left - 0.05) <= 0.05 * 1e-4):
        raise AssertionError("the clip did not bring the gradients to its norm")


def bootstrap_phase(dev, smi: str, ckpt: str) -> None:
    """The pretrain's checkpoint through `train_multistate --preset b8
    --ckpt`: the trunk's tensors bit-equal to the checkpoint's after the
    transfer, then 3 fine-tune steps (816 tokens, soft-masked: K5-lse and
    K6, 11 a step)."""
    from msvit_tpu_torch.examples import train_multistate as tm
    from msvit_tpu_torch.models.multistate import MultiStateViTForImageClassification
    from msvit_tpu_torch.train import restore_checkpoint

    params = restore_checkpoint(ckpt)["params"]
    cfg = tm.default_config(256, "b8")
    model = MultiStateViTForImageClassification(cfg, 10, device=dev)
    tm.load_pretrained_trunk(model, ckpt)
    got = {k: v.cpu() for k, v in model.encoder.state_dict().items()}
    trunk = [k for k in params if k.startswith("vit.encoder.layer.")]
    same = all(torch.equal(got["backbone." + k[len("vit.encoder."):]], params[k])
               for k in trunk)
    same &= torch.equal(got["embeddings.position_embeddings"],
                        params["vit.embeddings.position_embeddings"][:, 1:])
    same &= torch.equal(got["embeddings.patch_projection.weight"],
                        params["vit.embeddings.patch_projection.weight"])
    same &= all(torch.equal(got[f"backbone.{t}_token"], params["vit.embeddings.cls_token"][0, 0])
                for t in ("transmitter", "receiver"))
    log(f"[bootstrap] transfer_base_to_multistate: {len(trunk)} trunk tensors, the patch "
        f"projection, the position table without its CLS row and TX/RX from the CLS "
        f"token bit-equal to the checkpoint's: {same}")
    if not same or len(trunk) != LAYERS * 14:
        raise AssertionError("the transferred trunk differs from the checkpoint")
    del model, got
    _reset_ms_train_counts()
    t0 = time.perf_counter()
    losses = tm.main(["--steps", "3", "--preset", "b8", "--ckpt", ckpt])
    torch.cuda.synchronize()
    counts = _ms_train_counts()
    log(f"[bootstrap] train_multistate --preset b8 --ckpt: 3 steps in "
        f"{time.perf_counter() - t0:.1f} s (model build included); losses {losses}; "
        f"launches {counts} ({smi})")
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bootstrap losses {losses}")
    want = {"K5-lse": 3 * (LAYERS - 1), "K6": 3 * (LAYERS - 1), "K4": 0, "K5": 0}
    if counts != want:
        raise AssertionError(f"bootstrap launches {counts}, want {want}")


def int8_ab(tag: str) -> dict:
    """The int8 serving attention on the package beside this file, for an
    A/B of two trees in one call, each run from its root in turns (parent,
    change, change, parent):

        python3 -c "import chip_smoke as c; c.int8_ab('change')"

    The phases' own inputs and readouts: K3 on kernel_phase's input and K9
    on int8_attn_kernel_phase's with the soft mask of the served partition
    (the same weights, scene and draws as multistate_phase's), int8 out,
    through the wrapper (median of 20, CUDA events) and alone
    (`device_ms`); the device time of ms224_attn_modes_phase's int8
    forward and of slice_phase's int8 ViT-B/16 bs64 forward, and K9's and
    K3's part of each.  Prints one line, "AB " and a JSON object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.ops import packed_attention as pa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    cfg, run = ms224_int8(dev)
    out = run(cfg, "bf16")
    soft = _soft(out["last_cluster_indices"], out["num_clusters"])
    _, q, sec = int8_qkv(torch.Generator().manual_seed(0), MAIN_SHAPE, dev, scale=0.5)
    _, q9, sec9 = int8_qkv(torch.Generator().manual_seed(12), (MS_BATCH, 816, 2304), dev)
    inv = torch.tensor(20.0, device=dev)
    calls = {"K3": lambda: pa.packed_attention_int8(q, sec, 12, out_inv_scale=inv,
                                                    int8_out=True),
             "K9": lambda: pa.packed_attention_int8_masked(q9, sec9, 12, mask=soft,
                                                           out_inv_scale=inv, int8_out=True)}
    with torch.inference_mode():
        for k, fn in calls.items():
            res[f"{k}_ms"] = statistics.median(time_ms(fn, runs=20))
            res[f"{k}_alone_ms"] = device_ms(fn, "packed_attention_int8_kernel")
    res["ms224_int8_attn_device_ms"], res["ms224_K9_ms"] = ms224_int8_profile(cfg, run)
    del run
    vcfg, _, qparams, scales = vit_int8(dev)
    pix = wire_pixels(np.concatenate([serving_images()] * 2), dev)
    res["vit_int8_bs64_device_ms"], res["vit_K3_ms"] = int8_forward_profile(
        qparams, vcfg, scales, pix)
    print("AB " + json.dumps(res), flush=True)
    return res


def _summary(r: dict) -> dict:
    """A timed call's numbers for the kernels line (the kernel alone and the
    share of elements bit-equal to plain too, where its phase took them)."""
    return dict(max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                share_of_bound=r["bound_ms"] / r["ms"],
                **{k: r[k] for k in ("kernel_alone_ms", "bit_equal") if k in r})


def ptxas_lines() -> list:
    """Registers and spills of the packed (bf16 K1, K1-lse and K2 on the
    tensor cores, f32 on the CUDA cores), the fused and flash (bf16 K4, K5,
    K7 and K6 on the tensor cores: K4, K5 and K7 are instantiations of one
    tile body, told apart by their source and the SHAVED flag), the banded
    (bf16 K10 on the tensor cores) and the int8 kernels from ptxas's
    report."""
    from msvit_tpu_torch.ops import _build

    kernels = (r"packed_(?:bwd_dq|bwd_dkv|attention_lse|attention_int8|lse)(?:_mma)?_kernel|"
               r"packed_mma_kernel|fused_attention_kernel|flash_bwd_(?:dq|dkv)(?:_mma)?_kernel|"
               r"flash_(?:forward|mma)_kernel|banded(?:_mma)?_kernel")
    # the bf16 kernels on the tensor cores (templated on the head size only)
    tags = {"packed_mma_kernel": "K1", "packed_lse_mma_kernel": "K1-lse",
            "packed_bwd_dq_mma_kernel": "K2", "packed_bwd_dkv_mma_kernel": "K2",
            "flash_mma_kernel": "K7/K7-lse",
            "fused_attention_kernel": None, "flash_bwd_dq_kernel": "K6",
            "flash_bwd_dkv_kernel": "K6", "flash_forward_kernel": "K7/K7-lse",
            "flash_bwd_dq_mma_kernel": "K6", "flash_bwd_dkv_mma_kernel": "K6",
            "banded_kernel": "K10", "banded_mma_kernel": "K10",
            "packed_attention_int8_kernel": None}
    out, name, unit = [], None, None
    for line in _build.ptxas_report().read_text().splitlines():
        if line.startswith("$ "):  # the nvcc command of the next source
            unit = re.search(r"(\w+)\.cu$", line).group(1)
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        found = re.search(kernels, name) if m and name else None
        if found:
            kern = found.group(0)
            if kern == "fused_attention_kernel" or (
                    kern == "flash_mma_kernel" and unit == "fused_attention"):
                # K5-lse is K5 with an lse pointer; K4 is the SHAVED one
                tag = "K4" if "Lb1E" in name else "K5/K5-lse"
            elif kern == "packed_attention_int8_kernel":
                tag = "K9" if "Lb1E" in name else "K3"
            else:
                tag = tags.get(kern)
            if tag:
                kern = f"{tag} {kern}"
            dh = re.search(r"Li(\d+)E", name).group(1)
            dt = ("int8" if "int8" in kern
                  else "bf16" if "bfloat16" in name or "_mma_" in kern else "f32")
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
    torch.cuda.empty_cache()
    ms_launches, partition = multistate_phase(dev, smi)
    launches.update(ms_launches)
    torch.cuda.empty_cache()
    kernels.update(fused_kernel_phase(dev, smi, partition))
    torch.cuda.empty_cache()
    kernels.update(ms_train_kernel_phase(dev, smi, partition))
    torch.cuda.empty_cache()
    ms_train_grad_phase(dev, smi)
    torch.cuda.empty_cache()
    launches.update(ms_train_phase(dev, smi))
    torch.cuda.empty_cache()
    ms_train_example_phase(dev, smi)
    torch.cuda.empty_cache()
    launches.update(ms224_attn_modes_phase(dev, smi))
    torch.cuda.empty_cache()
    l448, part448 = ms448_phase(dev, smi)
    launches.update(l448)
    torch.cuda.empty_cache()
    kernels.update(flash_kernel_phase(dev, smi, part448))
    torch.cuda.empty_cache()
    kernels.update(banded_kernel_phase(dev, smi, part448, partition))
    torch.cuda.empty_cache()
    kernels.update(int8_attn_kernel_phase(dev, smi, partition))
    torch.cuda.empty_cache()
    kernels.update(grouped_kernel_phase(dev, smi, partition))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_") as out:
        pre_launches, ckpt = pretrain_phase(dev, smi, out)
        launches.update(pre_launches)
        torch.cuda.empty_cache()
        pretrain_variants_phase(dev, smi, out)
        torch.cuda.empty_cache()
        bootstrap_phase(dev, smi, ckpt)
    src = "msvit_tpu_torch/csrc/"
    # K6 and K10 at the other shapes their phases timed
    extra = {"K6": [("[8,12,3168,64] soft mask of the 448 partition", "K6@3168")],
             "K10": [("[8,32+3136,2304] one cluster", "K10@448 one-cluster"),
                     ("[8,32+784,2304] the 224 partition", "K10@224")]}
    packed, fused = "msvit_tpu/ops/packed_attention.py:", "msvit_tpu/ops/fused_attention.py:"
    flash = "msvit_tpu/ops/flash_attention.py:"
    rows = [
        dict(name=name, route="cuda", source=src + cu, replaces=tpu,
             launches=launches[k], **_summary(kernels[k]),
             **({"other_shapes": [dict(shape=tag, **_summary(kernels[key]))
                                  for tag, key in extra[k]]} if k in extra else {}))
        for k, name, cu, tpu in (
            ("K1", "packed_attention", "packed_attention.cu", packed + "118"),
            ("K3", "packed_attention_int8", "packed_attention_int8.cu", packed + "883"),
            ("K1-lse", "packed_attention_lse", "packed_attention_lse.cu", packed + "118"),
            ("K2", "packed_attention_bwd", "packed_attention_bwd.cu", packed + "682"),
            ("K4", "fused_attention_inference", "fused_attention.cu", fused + "303"),
            ("K5", "fused_attention", "fused_attention.cu", fused + "141"),
            ("K5-lse", "fused_attention_lse", "fused_attention.cu", fused + "141"),
            ("K6", "flash_attention_bwd", "flash_attention_bwd.cu", flash + "367"),
            ("K7", "flash_attention", "flash_attention.cu", flash + "242"),
            ("K9", "packed_attention_int8_masked", "packed_attention_int8.cu", packed + "1082"),
            ("K10", "token_rows", "banded_attention.cu",
             "msvit_tpu/ops/banded_attention.py:282"),
            # the TPU's head-grouped functions, computed by K1, K1-lse and K2
            ("K8a", "packed_attention (K8a)", "packed_attention.cu", packed + "288"),
            ("K8a-lse", "packed_attention_lse (K8a, with_lse)", "packed_attention_lse.cu",
             packed + "288"),
            ("K8b", "packed_attention_bwd (K8b)", "packed_attention_bwd.cu", packed + "641"),
        )
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
