"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (`msvit_tpu_torch`, never JAX) through its main path and
fails (non-zero exit, no result line) if any phase fails:

1. device: a CUDA card is required, there is no CPU fallback; prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the hand-written kernels from `msvit_tpu_torch/csrc`
   (one nvcc per source, in parallel) and prints ptxas's registers and
   spills for the training (the bf16 pair on the tensor cores: the wgmma
   kernels at head size 64, the mma.sync ones at every bucket), the wgmma
   kernel of K1, K4, K5 and K7 (`attention_wgmma.cuh`), K10's
   (`banded_wgmma_kernel`), K6's wgmma pair
   (`attention_bwd_wgmma.cuh`), the fused, flash, banded and int8 kernels
   (K3's and K9's wgmma kernel at head size 64, `attention_int8_wgmma.cuh`),
   and every line where ptxas serialized a kernel's wgmma products;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (max abs error against a stated tolerance), then
   both timed with CUDA events in turns (plain, kernel, kernel, plain):
   K1 and K3 (serving; both also alone by `torch.profiler` with their
   rates, K3 on s8 wgmma fed by TMA with its share bit-equal to plain, its
   launches by route, its blocks per SM and K1 beside it as the bf16
   yardstick; K3 also at the tile edges N 63, 64, 65, 127, 129), K1-lse and K2
   (training; masked, f32, large-logit in f32 and bf16 and dh-128 cases
   too; their achieved TFLOP/s and share of the bound, beside
   `scaled_dot_product_attention` and its backward through the call and by
   device time; the launches' routes, wgmma at dh 64 and mma.sync at dh
   128, the blocks per SM of both routes' kernels and their ptxas lines);
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
   of their own (both on wgmma), the partition's agreement with the plain path, ms/batch,
   img/s, clustering's share, peak memory and host syncs; each forward's
   device time and K4's or K5's share of it (`torch.profiler`);
9. fused kernels: K4 and K5 against their plain versions at [8,12,816,64]
   with the soft mask of the served partition (also a bool mask with a
   fully masked row, f32, and cross-context K/V), the share of elements
   bit-equal to plain, then timed through the wrapper and alone, with the
   achieved TFLOP/s and share of the bound, beside SDPA through its call
   and by its device time; the mma.sync kernel's blocks per SM (the route
   of the other head sizes);
10. multistate training kernels: K5-lse and K6 against their plain versions
   at [8,12,816,64] (the served partition's soft mask in bf16 and f32, a
   bool mask with a fully masked row, cross-context K/V, large logits, 6
   heads of 128, mask rows that are not 16-byte aligned: Nk 813 bool and
   814 f32), each case's route (wgmma at bf16 dh 64, mma.sync at dh 128,
   the CUDA cores in f32), two K6 calls bit for bit, then timed (each also
   alone, with its TFLOP/s);
11. multistate gradient: `MultiStateViTForImageClassification` at
   `benchmarks/bench_multistate_train_r3.py`'s config (shared-anchor NCut,
   bs8) on the kernel path against the plain attention path, the loss and
   the TX/RX/classifier gradients, without and with clustering events;
12. multistate training: `Trainer` takes 10 steps of the TX/RX tokens and
   the classifier; the loss falls, frozen weights stay bit-equal, K5-lse
   and K6 run 11 times a step, every launch on wgmma; ms/step, memory, host syncs, the step's
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
   them valid outputs; the banded forward (K10 in 11 layers, every launch
   on wgmma) against the
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
   the first event) and the 224 one ([8, 32+784, 2304]), then timed through
   the wrapper and alone, beside SDPA over the equivalent mask through its
   call and by its device time, with the 64-key tiles the band walks
   beside the pairs the partition needs;
18. masked int8 kernel: K9 at the tile edges N 63, 64, 65, 127, 129 (a
   bool mask whose last row is fully masked, mean(V), and the additive 0 /
   -100 mask), then against its plain version at [8,816,2304] with the 224
   partition's soft mask and a bool mask (its fully masked row mean(V)),
   bf16 and int8 out, the share bit-equal to plain, every launch on
   wgmma, then timed through the wrapper and alone, beside bf16 K4 at the
   same shape and mask; its blocks per SM;
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
   11 times a step);
23. the same checkpoint (a 784-row position table) into the 448-px
   multistate config (3136 rows): the table equals `interpolate_pos_embed`
   of the source's, and a clustered bf16 forward runs K7 in 11 layers;
24. interpolation: ViT-B/16 from its 224-px table at 384 px (577 tokens,
   bs16), bf16 (K1) and int8 (K3, calibrated at 384) against the plain
   attention path, ms/batch;
25. remat: the ViT-B/16 bs256 step with remat off, "" (every block
   recomputed), "dots" and "dots_no_batch": the gradients against remat
   off, K1-lse and K2 launches, ms/step, peak memory;
26. mu_dtype: 10 `Trainer` steps at bs64 with a bf16 first moment: the loss
   falls, mu is bf16, the state's bytes against the fused AdamW's, a resume
   bit for bit;
27. FPS and axis-align clustering at `bench.py`'s multistate config: int8
   (K4) and bf16 (K5) forwards, valid partitions, 11 launches per forward,
   ms/batch, host syncs, device time; `kway_ncut` and the TX compression
   on the card against the CPU;
28. predictive training: `examples.train_predictive_synthetic` at the
   sandbox config (ViT-B trunk, bs64, 64-px glimpses) for 10 steps, no
   kernel launched (its 8-token key-masked attention is the plain path,
   as in JAX), falling loss; the step's ms, img/s, peak memory and device
   time; 3 steps of `--losses all7`; one batch's loss and gradients in f32
   on the card against the CPU;
29. subsample: `bench.py`'s config (ViT-B width, 6 layers, 224 px, grid
   4 -> x2, depth 1, bs32) in open, lock and freeze mode: valid outputs (the
   valid slots tile the image once), no kernel launched (81 tokens, the
   plain path as in JAX), ms/batch, img/s, device time, host syncs, peak
   memory; the deep configuration (448 px, depth 3: 1,361 tokens, bs8) in
   open and freeze mode: K7 launched 24 and 6 times (its key-only mask read
   through a row stride of 0), the forward timed with K7's share, and with
   every slot split the kernel path against the plain attention path;
   `train_subsample_synthetic` for 3 + 3 steps and its evaluation;
30. key-only masks: K4, K5, K5-lse, K7 and K6 at [8,12,1361,64] with an
   additive [8,1,1,1361] mask (and Nq 1025), each against its plain version
   and bit-equal to itself given the mask expanded, then timed;
31. saccadic: `bench.py`'s config (ViT-B width, 512 patterns of complexity
   2, rank 64, beam 64, 448 px, 128-px glimpses): the batched run of 16
   images x 10 glimpses (no kernel launched, no host sync in the loop),
   ms/run, device time, peak memory; in f32 the first glimpse (embedding,
   prediction, next query) on the card against the CPU (2 images); the
   serial controller on one image; `train_saccadic` for 3 steps;
32. runtime: 64 q95 JPEGs at 900 x 675 (seeded scenes) decoded to 224 px by
   the native libjpeg decoder (its route counted, its mean difference from
   PIL's decode, img/s), or, where the machine has no libjpeg header, a line
   that says the decoder was not built and PIL's decode through the native
   preprocessor; ViT-B/16 @224 (phase 4's weights and scales) exported
   with a symbolic batch, int8 (K3) and bf16 (K1; also with the params
   bundled), reloaded in a child process that imports no model code and
   equal to the live model on every element at batches 1, 2 and 64; served
   through `BatchingServer` (phase 4's traffic on the decoded requests),
   printed beside phase 4's live model; `aot_compile` of the int8 bs64 forward (equal to
   eager, FLOPs within 1% of the analytic count); `Trainer.fit` fed by a
   `ResumableLoader` through `prefetch_to_device`, 6 steps straight against
   3 + a checkpoint + 3 in a fresh Trainer (losses bit for bit);
33. base extras (`extras_phase`), each route against the plain attention
   path: an HF-layout checkpoint (config.json + pytorch_model.bin, seeded,
   `facebook/dino-vitb8`'s geometry) through `load_pretrained_vit` into
   `zoo.build_config("dino-vitb8")`, bf16 (K1) and int8 (K3) at bs64 and
   785 tokens; the same checkpoint through `import_into_multistate` at
   `bench.py`'s multistate config, int8 (K4) and bf16 (K5) forwards, and 3
   steps of `train_multistate --pretrained` (K5-lse, K6); an MoE ViT-B/16
   (8 experts, dispatch, 31 slots of 197 tokens) forward at bs64 (K1),
   dispatch against dense without drops, the share of tokens dropped, 3
   `Trainer` steps (K1-lse, K2); ViT-B/16 with two heads a layer removed by
   `prune_heads` (H 10) through K1 and K3, equal to `prune_heads_masked`'s
   model; a DINOv2-B/14 checkpoint at 518 px (1,370 tokens, layer scale
   1e-5, bs8) through K1; K1 at [64,197,1920] and [8,1370,2304] and K3 at
   [64,197,1920] against their plain versions, timed;
34. the parallel layer (`parallel_phase`) at world size 1 over NCCL (an
   in-process group on a `file://` store, destroyed at the end): ViT-B/16
   @224 bs64 through `make_sharded_train_step` as data parallel, ZeRO-1
   and FSDP (3 steps each) against the `Trainer`'s step on the same
   weights and batch, timed in turns with it (ms/step, peak memory, 12
   K1-lse and 12 K2 a step); the trunk with `sequence_sharding` through
   `parallelize` against the plain trunk (K1); ring attention at
   [8,3168,12,64] bf16 in 4 blocks, every rank's block steps in one
   process (K7-lse and K6 per step) against `FlashAttentionFunction` with
   a padding-tail key mask that blanks a whole block, `ring_attention` at
   world size 1, the ring forward timed beside dense K7 with its top
   kernels; GPipe at S = 1 with 4 microbatches against the unpipelined
   classifier (K1); one `parallel {...}` line;
35. export -> reload -> serve of the clustered families
   (`export_families_phase`): the 224-px multistate encoder (`bench.py`'s
   config) in bf16 (K5), int8 (K4) and int8 with `attn_mode="int8"` (K9),
   the 448-px one dense (K7) and banded (K10), and the subsample forward
   at 448 px, depth 3 (K7, key-only mask), each taking uint8 requests (the
   448-px ones f32 pixels) and
   exported with a symbolic batch by a child process of its own (all at
   once: seconds, bytes, graph nodes), reloaded by another that imports no
   model code: every element equal to the live model at batches 1, 2 and
   8, its K launched once a layer and no other; then in turns lone
   requests through the live model and the artifact, and the bf16 and int8
   224-px artifacts served by a `BatchingServer`; one `families {...}`
   line.

Every kernel is timed beside the least time the card could take for its
work (`bound`) and, where one PyTorch call computes the same function,
that call (`scaled_dot_product_attention` or its backward; the port never
calls it).  The second-to-last line is a JSON object with each kernel's
launches in its path's run (serving for K1 and K3, with the reloaded
artifacts' launches of phase 32, training for K1-lse and
K2 (split by route: every one on wgmma; the K1, K3, K4, K5, K5-lse, K6,
K7, K8a, K9 and K10 rows split theirs too, and none may take mma.sync), the
clustered multistate forwards for K4 and K5, multistate training
for K5-lse and K6, the clustered 448-px bf16 forward and the deep subsample
forwards for K7, the 224-px int8-attention forward for K9, the 448-px banded forward for K10, the
ViT-B/8 pretrain run for the K8a, K8a-lse and K8b rows; the extras
phase's launches added to the K1, K3, K1-lse, K2, K4, K5, K5-lse and K6
rows, the parallel phase's to the K1, K1-lse, K2, K7 (K7-lse) and K6
rows, the reloaded clustered families' to the K4, K5, K7, K9 and K10
rows), its error, its time beside the plain version's, the library call's and the
bound, and its share of the bound (K1, K8a, K3 and K7 also alone; K6 and K10 also at their other timed
shapes, K4, K5, K5-lse, K6 and K7 with the key-only mask, K1 and K3 at
the extras' shapes); the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import functools
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

# profiler names.  K4 and K5 / K5-lse at bf16 head size 64 on the kernel K7
# runs (attention_wgmma_kernel, tagged FusedInferenceUnit and FusedUnit), at
# other head sizes on flash_mma_kernel (K4's route at every head size before
# its wgmma instantiation), f32 on fused_attention_kernel.  K6: its two
# wgmma or mma.sync kernels; K10: banded_wgmma_kernel or banded_mma_kernel
# (either tree's names in an A/B).
K45_KERNELS = "flash_mma_kernel|fused_attention_kernel|attention_wgmma_kernel"
K6_KERNELS = r"flash_bwd_d(?:q|kv)_w?g?mma_kernel"
K10_KERNELS = r"banded_w?g?mma_kernel"
# K3 and K9: the wgmma kernel at head size 64 (`attention_int8_wgmma.cuh`),
# packed_attention_int8_kernel (mma.sync) at other head sizes, and at dh 64
# in a tree before it (either tree's names in an A/B)
K39_KERNELS = r"packed_attention_int8_(?:wgmma_)?kernel"


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


def _profiled_calls(fn, runs: int, attempt: int):
    """The card's events of `runs` calls of `fn` in one `torch.profiler`
    profile, sorted by start, or None when the profile lost a mark.  On
    the H100 the profiler drops the kernels whose card timestamps, mapped
    to the host's clock, fall before the profile's start (the card's read
    ms early), and a profile can also lose its first launches
    (`tools/profiler_probe.py` counts both).  So the
    calls sit behind a lead-in (a 0.1 s host sleep, then 256 one-element
    adds, twice as many on each further `attempt`) and between two marks
    (`torch.cuda._sleep`'s spin kernel), the second one before 64 adds and
    a short sleep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        time.sleep(0.1)
        for _ in range(256 << attempt):
            pad.add_(1)
        torch.cuda._sleep(100_000)
        for _ in range(runs):
            fn()
        torch.cuda._sleep(100_000)
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.02)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if len(marks) != 2:
        log(f"[profile] {len(marks)} of 2 marks in the profile (at {marks} of "
            f"{len(events)} events): taken again")
        return None
    return events[marks[0] + 1:marks[1]]


def device_profile(fn, pattern: str, kernels: int, runs: int = 3,
                   median: bool = False) -> tuple:
    """Device time (ms) per call of `fn`, summed over every kernel, copy and
    set it ran on the card, and the part of it in the kernels whose names
    match `pattern` (`torch.profiler`, `runs` calls after one of warm-up;
    `median`: per name, the median launch times its launches per call).
    A call launches `kernels` of those.  A profile without both marks, or
    with another count than runs x kernels between them, is taken again
    with a longer lead-in (`_profiled_calls`), at most four times, and then
    the readout fails."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        events = _profiled_calls(fn, runs, attempt)
        if events is not None:
            matched = [e for e in events if re.search(pattern, e.name)]
            if len(matched) == runs * kernels:
                break
            log(f"[profile] {len(matched)} of {runs * kernels} launches matching "
                f"{pattern!r} between the marks: taken again")
    else:
        raise AssertionError(f"torch.profiler lost launches matching {pattern!r} in five "
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


def top_kernels(fn, k: int = 6, runs: int = 3) -> str:
    """The `k` kernels (by name) that take the most device time per call
    of `fn` (`torch.profiler`, `runs` calls after one of warm-up), with
    their ms per call and launches per call."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        events = _profiled_calls(fn, runs, attempt)
        if events is not None:
            break
    else:
        raise AssertionError("torch.profiler lost a mark in five profiles")
    per = {}
    for e in events:
        t, n = per.get(e.name, (0.0, 0))
        per[e.name] = (t + e.device_time_total, n + 1)
    top = sorted(per.items(), key=lambda x: -x[1][0])[:k]
    return "; ".join(f"{name[:60]} {t / runs / 1e3:.3f} ms x{n // runs}"
                     for name, (t, n) in top)


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
        packed_attention_int8_plain, packed_attention_plain, route_counts, unpack_qkv)

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
        k1_alone = device_ms(lambda: packed_attention(x, 12), "attention_wgmma_kernel")
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
        k3_before = route_counts()["K3"]
        got, want = packed_attention_int8(q, sec, 12), packed_attention_int8_plain(q, sec, 12)
        inv = 127.0 / want.float().abs().amax()
        gq = packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True)
        wq = packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv, int8_out=True)
        e_k3, same, _ = _int8_bars("kernels", "K3 int8 [64,197,2304]", got, want, gq, wq)
        k3_routes = {r: c - k3_before[r] for r, c in route_counts()["K3"].items()}
        log(f"[kernels] K3 int8 [64,197,2304]: launches by route {k3_routes}")
        if k3_routes != {"wgmma": 2, "mma.sync": 0, "cuda_cores": 0}:
            raise AssertionError(f"K3 at [64,197,2304]: launches by route {k3_routes}")
    int8_edge_cases(dev, "kernels", masked=False)
    with torch.inference_mode():
        k3_ms, k3_plain = race(
            lambda: packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True),
            lambda: packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv,
                                                int8_out=True))
        k3_alone = device_ms(
            lambda: packed_attention_int8(q, sec, 12, out_inv_scale=inv, int8_out=True),
            K39_KERNELS)
        k3_bound = bound([q, sec], [gq], ops, torch.int8)
    torch.cuda.synchronize()
    log(f"[kernels] K1 bf16 [64,197,2304]: kernel {k1_ms!r} ms, plain {k1_plain!r} ms, "
        f"library (scaled_dot_product_attention) {k1_lib!r} ms, bound {k1_bound}; "
        f"{rate(ops, k1_ms, k1_bound)} (median of 20, CUDA events; {smi}); the kernel "
        f"alone {k1_alone!r} ms (device time, torch.profiler; "
        f"{rate(ops, k1_alone, k1_bound)})")
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


def _int8_bars(tag: str, label: str, got, want, gq, wq) -> tuple:
    """K3's and K9's bars against their plain versions: bf16 out within
    K3_BF16_REL_TOL x max |plain|, int8 out within one step with at least
    99% of the elements equal.  Returns (the bf16 error, the int8 share
    equal, the bf16 share bit-equal), printed."""
    err = _check(tag, f"{label}, bf16 out", max_err(got, want),
                 K3_BF16_REL_TOL * want.float().abs().max().item())
    delta = (gq.int() - wq.int()).abs()
    same = (delta == 0).float().mean().item()
    same_bf16 = (got == want).float().mean().item()
    log(f"[{tag}] {label}, int8 out: max |delta| {delta.max().item()} (tolerance 1), "
        f"exactly equal {same!r} (tolerance >= 0.99); bf16 out bit-equal to plain on "
        f"{same_bf16!r} of the elements")
    if delta.max().item() > 1 or same < 0.99:
        raise AssertionError(f"{label}: int8 out disagrees with its plain version")
    return err, same, same_bf16


INT8_EDGE_NS = (63, 64, 65, 127, 129)  # around the 64-key tiles and 128-row items


def int8_edge_cases(dev, tag: str, masked: bool) -> None:
    """K3, or K9 with a bool mask [2,1,N,N] whose last row is fully masked
    (mean(V)) and the additive 0 / -100 mask [2,12,N,N], at head size 64
    ([2, N, 2304]) against the plain version at the tile edges
    `INT8_EDGE_NS`, bf16 and int8 out (`_int8_bars`); every launch on the
    wgmma route."""
    from msvit_tpu_torch.ops import packed_attention as pa

    k = "K9" if masked else "K3"
    g = torch.Generator().manual_seed(21 + int(masked))
    before = pa.route_counts()[k]
    calls = 0
    for n in INT8_EDGE_NS:
        _, q, sec = int8_qkv(g, (2, n, 2304), dev)
        if masked:
            mb = torch.rand(2, 1, n, n, generator=g) < 0.7
            mb[1, 0, n - 1, :] = False
            ma = -100.0 * (torch.rand(2, 12, n, n, generator=g) < 0.5).float()
            cases = [("bool mask [2,1,N,N], the last row fully masked", mb.to(dev)),
                     ("additive 0/-100 mask [2,12,N,N]", ma.to(dev))]
        else:
            cases = [("no mask", None)]
        for mlabel, m in cases:
            def kernel(inv=None, m=m):
                if masked:
                    return pa.packed_attention_int8_masked(q, sec, 12, mask=m, out_inv_scale=inv,
                                                           int8_out=inv is not None)
                return pa.packed_attention_int8(q, sec, 12, out_inv_scale=inv,
                                                int8_out=inv is not None)

            def plain(inv=None, m=m):
                if masked:
                    return pa.packed_attention_int8_masked_plain(
                        q, sec, 12, mask=m, out_inv_scale=inv, int8_out=inv is not None)
                return pa.packed_attention_int8_plain(q, sec, 12, out_inv_scale=inv,
                                                      int8_out=inv is not None)

            with torch.inference_mode():
                got, want = kernel(), plain()
                inv = 127.0 / want.float().abs().amax()
                gq, wq = kernel(inv), plain(inv)
            calls += 2
            label = f"{k} int8 [2,{n},2304] {mlabel}"
            _int8_bars(tag, label, got, want, gq, wq)
            if m is not None and m.dtype == torch.bool:  # mean(V): s_v times the mean of v
                mean = q[1, :, 2 * 768:].float().mean(0) * sec[2]
                _check(tag, f"{label}: the fully masked row vs mean(V)", max_err(got[1, n - 1], mean),
                       K3_BF16_REL_TOL * want.float().abs().max().item())
    took = {r: c - before[r] for r, c in pa.route_counts()[k].items()}
    log(f"[{tag}] {k} at the tile edges N {list(INT8_EDGE_NS)}: launches by route {took}")
    if took != {"wgmma": calls, "mma.sync": 0, "cuda_cores": 0}:
        raise AssertionError(f"{k}: the tile edges' launches by route {took}, want {calls} "
                             f"on wgmma")


def int8_occupancy(dh: int, shape: tuple, masked: bool) -> str:
    """Blocks per SM of the int8 kernel (K3, or K9 with a bf16, a bool and
    no mask; the runtime's occupancy calculator) and how a [B, H, N] call
    fills the card: at head size 64 the wgmma kernel's persistent blocks
    over items of 128 query rows, else the mma.sync kernel's (H, N / 64, B)
    grid in waves."""
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if dh == 64:
        qtiles = -(-n // 128)
        items = b * h * qtiles
        return (f"int8 wgmma kernel blocks per SM at dh {dh} (384 threads): {per_sm}; {items} "
                f"items of 128 query rows of [{b},{h},{n},{dh}] over {min(items, sms)} "
                f"persistent blocks: {items / sms!r} items an SM; {-(-n // 16)} of "
                f"{8 * qtiles} warps of a head's items hold rows")
    tiles = -(-n // 64)
    blocks = b * h * tiles
    slots = sms * list(per_sm.values())[0]
    return (f"int8 kernel blocks per SM at dh {dh}: {per_sm}; {blocks} blocks of "
            f"[{b},{h},{n},{dh}] over {slots} slots: {blocks / slots!r} waves; "
            f"{-(-n // 16)} of {4 * tiles} warps of a head's blocks hold rows")


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def slice_phase(dev, smi: str) -> dict:
    from msvit_tpu_torch.models.base import ViTModel

    t0 = time.perf_counter()
    cfg, model, qparams, scales = vit_int8(dev)
    torch.cuda.synchronize()
    log(f"[slice] ViT-B/16 built, quantized, calibrated on 64 images in "
        f"{time.perf_counter() - t0:.1f} s")

    def normalize(u8):
        return wire_pixels(u8, dev)

    int8_fn, bf16_fn = serving_fns(cfg, model, qparams, scales, dev)
    images = serving_images()
    served = _serve_through(int8_fn, bf16_fn, images, "slice")
    stats, wall, launches, responses = (served[k] for k in ("stats", "wall", "launches",
                                                             "responses"))
    log(f"[slice] served {stats['requests']} requests in {wall:.3f} s: "
        f"{stats['requests'] / wall!r} img/s sustained; 64 single requests "
        f"{served['lone']!r} img/s, 448 in bursts of 64 {served['burst']!r} img/s; "
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
        if feat.shape != (cfg.hidden_size,) or not torch.isfinite(feat).all():
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
    served.pop("responses")
    return launches, served


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


def serving_fns(cfg, model, qparams, scales, dev) -> tuple:
    """Phase 4's apply functions (uint8 wire images -> CLS features and the
    route, 1 int8 and 0 bf16): (int8_fn, bf16_fn)."""
    from msvit_tpu_torch.models.base.quantized import quantized_vit_apply

    def int8_fn(u8):
        with torch.inference_mode():
            f = quantized_vit_apply(qparams, cfg, wire_pixels(u8, dev), act_scales=scales)
            return f[:, 0].float(), torch.ones(len(u8), device=dev)

    def bf16_fn(u8):
        with torch.inference_mode():
            f = model(wire_pixels(u8, dev))["last_hidden_state"]
            return f[:, 0].float(), torch.zeros(len(u8), device=dev)

    return int8_fn, bf16_fn


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

    return device_profile(fwd, K39_KERNELS, cfg.num_hidden_layers)



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


def train_occupancy() -> str:
    """Blocks per SM of K1-lse's and K2's bf16 kernels at head size 64, the
    wgmma route against the mma.sync kernels of the dh-64 bucket that it
    replaced there (the runtime's occupancy calculator)."""
    import ctypes

    from msvit_tpu_torch.ops import _build

    lib = _build.library()

    def blocks(fn, *args):
        out = ctypes.c_int(0)
        _build.check(lib, fn(*args, ctypes.byref(out)), fn.__name__)
        return out.value

    parts = []
    for wgmma, route in ((1, "wgmma"), (0, "mma.sync")):
        parts.append(f"{route}: K1-lse {blocks(lib.msvit_packed_attention_lse_occupancy, wgmma, 64)}"
                     f", K2 dQ {blocks(lib.msvit_packed_attention_bwd_occupancy, wgmma, 0, 64)}"
                     f", K2 dK/dV {blocks(lib.msvit_packed_attention_bwd_occupancy, wgmma, 1, 64)}")
    return ("blocks per SM at dh 64 (" + "; ".join(parts) + "; the wgmma blocks are 384 "
            "threads of 128 rows, the mma.sync ones 128 threads of 64)")


def _pair_routes(counts: dict) -> dict:
    """K1-lse's and K2's entries of a `route_counts()`."""
    return {k: counts[k] for k in ("K1-lse", "K2")}


def _ptxas_train() -> str:
    """ptxas's registers and spills of K1-lse's and K2's bf16 kernels at dh 64."""
    return "; ".join(line for line in ptxas_lines()
                     if ("K1-lse" in line or "K2" in line) and "dh64" in line)


def train_kernel_phase(dev, smi: str) -> dict:
    """K1-lse and K2 against their plain versions, then timed."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_bwd_plain, packed_attention_lse,
        packed_attention_lse_plain, route_counts, unpack_qkv)

    _reset_training_counts()
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
        lib_bwd = sdpa_bwd(*qkv, gr.reshape(x.shape[0], x.shape[1], 12, -1).transpose(1, 2))
        b_lib = library_ms(lib_bwd)
        # the library calls by device time: every kernel of the call
        f_lib_dev = device_profile(lambda: sdpa(*qkv), r"^$", 0)[0]
        b_lib_dev = device_profile(lib_bwd, r"^$", 0)[0]
    torch.cuda.synchronize()
    b, n, d3 = MAIN_SHAPE
    f_ops, b_ops = (attn_ops(b, 12, n, n, d3 // 36, k) for k in (2, 5))
    f_bound = bound([x], [wo, wl], f_ops, torch.bfloat16)
    # K2 writes dqkv, x's shape and dtype
    b_bound = bound([x, wo, wl, gr], [x], b_ops, torch.bfloat16)
    log(f"[train-kernels] K1-lse bf16 [64,197,2304]: kernel {f_ms!r} ms, plain "
        f"{f_plain!r} ms, library (scaled_dot_product_attention) {f_lib!r} ms (device "
        f"time {f_lib_dev!r} ms), bound {f_bound}; {rate(f_ops, f_ms, f_bound)} (median of "
        f"20, CUDA events; {smi})")
    log(f"[train-kernels] K2 bf16 [64,197,2304]: kernel {b_ms!r} ms, plain "
        f"{b_plain!r} ms, library (its backward) {b_lib!r} ms (device time {b_lib_dev!r} "
        f"ms), bound {b_bound}; {rate(b_ops, b_ms, b_bound)} (median of 20, CUDA events; "
        f"{smi})")
    log(f"[train-kernels] routes of the cases above {_pair_routes(route_counts())}; "
        f"{train_occupancy()}; ptxas: {_ptxas_train()}")
    return {"K1-lse": dict(err=e_fwd, ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                           library_device_ms=f_lib_dev, **f_bound),
            "K2": dict(err=e_bwd, ms=b_ms, plain_ms=b_plain, library_ms=b_lib,
                       library_device_ms=b_lib_dev, **b_bound)}


def _training_counts():
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_lse)

    return {"K1-lse": _routed_count(packed_attention_lse),
            "K2": _routed_count(packed_attention_bwd)}


def _reset_training_counts():
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_bwd, packed_attention_lse, zero_counts)

    zero_counts(packed_attention_lse, packed_attention_bwd)


class Launches(int):
    """A launch count of K1, K1-lse, K2, K5, K5-lse, K6, K7 or K7-lse that carries its split by route
    (`routes`: {"wgmma": n, "mma.sync": n, "cuda_cores": n}).  The phases
    read these counts as `Launches` (`_routed_count`), and their sums keep
    the split, so that the kernels line shows each row's launches by
    route; adding a count without its split raises."""

    def __new__(cls, n: int, routes: dict):
        if sum(routes.values()) != n:
            raise AssertionError(f"{n} launches, by route {routes}")
        obj = super().__new__(cls, n)
        obj.routes = dict(routes)
        return obj

    def __add__(self, other):
        if isinstance(other, Launches):
            return Launches(int(self) + int(other), {r: n + other.routes[r]
                                                     for r, n in self.routes.items()})
        if other == 0:
            return self
        raise TypeError(f"{other} launches without their routes")

    __radd__ = __add__


def _routed_count(fn) -> Launches:
    """A routed wrapper's launches since `zero_counts`, with their routes."""
    from msvit_tpu_torch.ops.packed_attention import routes_of

    return Launches(fn.launches, routes_of(fn))


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

    return {"K4": _routed_count(fused_attention_inference),
            "K5": _routed_count(fused_attention)}


def _reset_fused_counts() -> None:
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference)
    from msvit_tpu_torch.ops.packed_attention import zero_counts

    zero_counts(fused_attention_inference, fused_attention)


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
    _on_wgmma("multistate int8 forward", n_int8, ("K4",))
    _on_wgmma("multistate bf16 forward", n_bf16, ("K5",))
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
    # K4's and K5's kernels (at head size 64 on wgmma; and the mma.sync and
    # CUDA-core kernels, which ran them in bf16 before, so that an older tree
    # reads the same way)
    attn = K45_KERNELS
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
            lib_dev = device_profile(lambda: sdpa(q, k, v, soft), r"^$", 0)[0]
            alone = device_ms(lambda: fn(q, k, v, mask=soft), K45_KERNELS)
            ops = attn_ops(b, h, n, n, dh, 2)
            lim = bound([q, k, v, soft], [q], ops, torch.bfloat16)
            torch.cuda.synchronize()
            log(f"[fused-kernels] {name} bf16 {list(MS_SHAPE)} soft mask: kernel {ms!r} ms, "
                f"plain {plain_ms!r} ms, library (scaled_dot_product_attention, the mask "
                f"in bf16) {lib!r} ms ({lib_dev!r} ms device time, every kernel of the "
                f"call), bound {lim}; {rate(ops, ms, lim)} (median of 20, CUDA events; "
                f"{smi}); the kernel alone {alone!r} ms (device time, torch.profiler; "
                f"{rate(ops, alone, lim)})")
            res[name] = dict(err=errs[0], ms=ms, plain_ms=plain_ms, library_ms=lib,
                             library_device_ms=lib_dev, kernel_alone_ms=alone,
                             bit_equal=same, **lim)
    log(f"[fused-kernels] the mma.sync kernel of K4 and K5, the route of head sizes other "
        f"than 64 (at 64 both run the persistent wgmma kernel, one block an SM): "
        f"{occupancy(dh, (b, h, n))} ({smi})")
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

    return {"K5-lse": _routed_count(fused_attention_lse),
            "K6": _routed_count(flash_attention_bwd), **_fused_counts()}


def _reset_ms_train_counts() -> None:
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd
    from msvit_tpu_torch.ops.fused_attention import fused_attention_lse
    from msvit_tpu_torch.ops.packed_attention import zero_counts

    zero_counts(fused_attention_lse, flash_attention_bwd)
    _reset_fused_counts()


def _k56_routes() -> dict:
    """K5's, K5-lse's and K6's launches by route since their counts were
    set to 0."""
    from msvit_tpu_torch.ops.packed_attention import route_counts

    return {k: v for k, v in route_counts().items() if k in ("K5", "K5-lse", "K6")}


def _on_wgmma(label: str, counts: dict, keys) -> None:
    """Every launch of the kernels `keys` in `counts` (`Launches`) took the
    wgmma route: the main path's trunks are bf16 at head size 64."""
    for k in keys:
        routes = counts[k].routes
        if routes["wgmma"] != counts[k] or not counts[k]:
            raise AssertionError(f"{label}: {k} launched {int(counts[k])} times, by route "
                                 f"{routes}: want every launch on wgmma")


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
    _reset_ms_train_counts()
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
        # bf16 at head size 64 on wgmma (5 cases), [8,6,816,128] on mma.sync,
        # f32 on the CUDA cores (2)
        routes = _k56_routes()
        want = {"wgmma": 5, "mma.sync": 1, "cuda_cores": 2}
        if routes != {"K5": dict.fromkeys(want, 0), "K5-lse": want, "K6": want}:
            raise AssertionError(f"K5-lse/K6 routes of the cases {routes}")
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
                            K6_KERNELS, kernels=2)
        # each of its two kernels alone
        b_split = {which: device_ms(lambda: flash_attention_bwd(q, k, v, wo, gb, wl, soft),
                                    rf"flash_bwd_{which}_w?g?mma_kernel")
                   for which in ("dq", "dkv")}
        f_alone = device_ms(lambda: fused_attention_lse(q, k, v, mask=soft), K45_KERNELS)
        # no atomics: two calls, the same bits
        same_bits = all(torch.equal(a, c) for a, c in zip(
            flash_attention_bwd(q, k, v, wo, gb, wl, soft),
            flash_attention_bwd(q, k, v, wo, gb, wl, soft)))
        if not same_bits:
            raise AssertionError("K6: two calls gave different bits")
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
        f"torch.profiler; {rate(b_ops, b_alone, b_bound)}; dQ {b_split['dq']!r} ms, dK/dV "
        f"{b_split['dkv']!r} ms); two calls the same bits "
        f"{same_bits}; routes of the eight cases {routes}")
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
    # a step launches K5-lse and K6's two kernels once a layer (no K1 or K7)
    d_step, attn = device_profile(one_step, f"{K45_KERNELS}|{K6_KERNELS}", 3 * (LAYERS - 1))
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
    _on_wgmma("multistate fine-tune step", launches, ("K5-lse", "K6"))
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

    return {**_fused_counts(), "K7": _routed_count(flash_attention),
            "K9": _routed_count(packed_attention_int8_masked), "K10": _routed_count(token_rows)}


def _reset_attn_counts() -> None:
    from msvit_tpu_torch.ops.banded_attention import token_rows
    from msvit_tpu_torch.ops.flash_attention import flash_attention
    from msvit_tpu_torch.ops.packed_attention import packed_attention_int8_masked, zero_counts

    _reset_fused_counts()
    zero_counts(flash_attention, token_rows, packed_attention_int8_masked)


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
    _on_wgmma("ms448 banded bf16 forward", launches, ("K10",))
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
    return device_profile(lambda: run(cfg, "int8"), K39_KERNELS, LAYERS - 1)


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
        alone = device_ms(lambda: flash_attention(q, k, v, mask=soft), "attention_wgmma_kernel")
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
        f"{lim}; {rate(ops, ms, lim)} (median of 20, CUDA events; {smi}); the kernel alone "
        f"{alone!r} ms (device time, torch.profiler; {rate(ops, alone, lim)})")
    res = {"K7": dict(err=errs[0], ms=ms, plain_ms=plain_ms, library_ms=lib,
                      kernel_alone_ms=alone, **lim)}
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


def k10_inputs(gen, cid, h: int, dh: int, dev) -> torch.Tensor:
    """K10's packed qkv [B, 2C + N, 3 h dh] in f32 for the sorted ids `cid`
    [B, N], drawn at 0.5 from `gen`, the q third pre-scaled (the kernel's
    scale is 1) to scores of std 2: a row weighs a few dozen keys of its
    cluster, not their flat mean, so that a dropped key tile or RX key
    moves the output by more than K1's bar of max |plain|."""
    b, n = cid.shape
    x = torch.randn(b, 2 * MS_CLUSTERS + n, 3 * h * dh, generator=gen) * 0.5
    x[..., :h * dh] *= 8 * dh**-0.5
    return x.to(dev)


def k10_sdpa(x, cid, h: int):
    """The library yardstick of K10 on the packed qkv `x`: one
    `scaled_dot_product_attention` call of the token rows' queries over
    every key with the equivalent mask (a token's own cluster and its RX
    key) in x's dtype, scale 1.  Returns the call as a function."""
    b, n = cid.shape
    pfx = x.shape[1] - n
    cols = torch.arange(pfx + n, device=x.device)
    key_cid = F.pad(cid, (pfx, 0), value=-1)
    keep = (cols[None, None] == 2 * cid[:, :, None] + 1) | (
        (cols[None, None] >= pfx) & (cid[:, :, None] == key_cid[:, None, :]))
    add = torch.where(keep, 0.0, float("-inf")).to(x.dtype)[:, None]
    t = x.reshape(b, pfx + n, 3, h, -1).permute(2, 0, 3, 1, 4)
    return lambda: F.scaled_dot_product_attention(t[0][:, :, pfx:], t[1], t[2],
                                                  attn_mask=add, scale=1.0)


def k10_work(cid) -> tuple:
    """The work of K10 on the sorted ids `cid` [B, N]: the cluster sizes
    [B, C], the query-key pairs the partition needs (same-cluster keys and
    each token's RX key) and the pairs its band's 64-key tiles hold (what
    the wgmma kernel multiplies, the RX tile aside)."""
    from msvit_tpu_torch.ops.banded_attention import BAND_KEYS, BAND_ROWS, band_limits

    sizes = torch.stack([torch.bincount(r, minlength=MS_CLUSTERS) for r in cid]).double()
    pairs = (sizes**2).sum().item() + cid.numel()
    band = band_limits(cid.to(torch.int32), MS_CLUSTERS)
    walked = ((band[:, 1] - band[:, 0] + 1).double() * BAND_ROWS * BAND_KEYS).sum().item()
    return sizes, pairs, walked


def banded_kernel_phase(dev, smi: str, part448, part224) -> dict:
    """K10 against its plain version on the token rows of each partition
    (sorted by cluster id, a stable sort): [8, 32+3136, 2304] at 448 px (and
    one cluster, the band of the layers before the first event) and
    [8, 32+784, 2304] at 224, bf16 (f32 at 224 too); then timed.  Its work
    depends on the partition: the bound counts the pairs of tokens in one
    cluster plus each token's RX key, the work this data needs (the band's
    tiles and the dense N x S are logged as upper bounds)."""
    from msvit_tpu_torch.ops.banded_attention import token_rows, token_rows_plain

    h, dh = 12, 64
    gen = torch.Generator().manual_seed(11)
    res = {}
    one = torch.zeros_like(part448[0])  # the layers before the first event
    for tag, (ids, _) in (("448", part448), ("224", part224),
                          ("448 one-cluster", (one, None))):
        cid = torch.sort(ids, dim=1, stable=True).values
        b, n = cid.shape
        x = k10_inputs(gen, cid, h, dh, dev)
        xb = x.to(torch.bfloat16)
        shape = f"[{b}, {2 * MS_CLUSTERS}+{n}, {3 * h * dh}]"
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
                # the bar scales with the output: no floor of 1
                tol = K1_TOL[xx.dtype] * want.float().abs().max().item()
                err = _check("banded-kernels", f"K10 {label} (bar: K1's of max |plain|)",
                             max_err(got, want), tol)
                if xx is xb:
                    e_bf16 = err
                del got, want
            torch.cuda.empty_cache()
            ms, plain_ms = race(lambda: token_rows(xb, cid, h, MS_CLUSTERS),
                                lambda: token_rows_plain(xb, cid, h, MS_CLUSTERS))
            alone = device_ms(lambda: token_rows(xb, cid, h, MS_CLUSTERS), K10_KERNELS)
            # the library yardstick: SDPA over the token rows' queries and
            # every key, the equivalent mask (own cluster, own RX) in bf16
            lib_fn = k10_sdpa(xb, cid, h)
            lib = library_ms(lib_fn)
            lib_dev = device_profile(lib_fn, r"^$", 0)[0]
            del lib_fn
        sizes, pairs, walked = k10_work(cid)
        out = torch.empty(b, n, h * dh, dtype=torch.bfloat16, device=dev)
        lim = bound([xb, cid.to(torch.int32)], [out], 4.0 * h * dh * pairs, torch.bfloat16)
        log(f"[banded-kernels] K10 bf16 {shape} ({tag} partition, cluster sizes "
            f"{sizes.sum(0).long().tolist()}): kernel {ms!r} ms, plain {plain_ms!r} ms, "
            f"library (scaled_dot_product_attention, the equivalent mask in bf16) {lib!r} ms "
            f"({lib_dev!r} ms device time, every kernel of the call), bound {lim} for the "
            f"{pairs:.0f} query-key pairs this partition needs; "
            f"{rate(4.0 * h * dh * pairs, ms, lim)}; the band's 64-key tiles (what the "
            f"wgmma kernel multiplies, the RX tile aside) {walked:.0f} pairs, "
            f"{walked / pairs!r} of the needed; dense {b * n * (2 * MS_CLUSTERS + n)} "
            f"(median of 20, CUDA events; {smi}); the kernel alone {alone!r} ms "
            f"({rate(4.0 * h * dh * pairs, alone, lim)}; device time, torch.profiler), the "
            f"rest the wrapper's band table and launch")
        res["K10" if tag == "448" else f"K10@{tag}"] = dict(
            err=e_bf16, ms=ms, plain_ms=plain_ms, library_ms=lib, library_device_ms=lib_dev,
            kernel_alone_ms=alone, walked_over_needed=walked / pairs, **lim)
    return res


def int8_attn_kernel_phase(dev, smi: str, partition) -> dict:
    """K9 against its plain version at [8,816,2304] (per-section quantized
    qkv) with the 224 partition's soft mask, bf16 and int8 out, also a bool
    mask with a fully masked row (mean(V)); the share bit-equal to plain;
    then the int8-out call timed, through the wrapper and alone, beside
    bf16 K4 at the same shape and mask; the kernel's blocks per SM."""
    from msvit_tpu_torch.ops.fused_attention import fused_attention_inference
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention_int8_masked, packed_attention_int8_masked_plain, route_counts,
        unpack_qkv, zero_counts)

    int8_edge_cases(dev, "int8-attn-kernels", masked=True)
    zero_counts(packed_attention_int8_masked)
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
            inv = 127.0 / want.float().abs().amax()
            gq = packed_attention_int8_masked(q, sec, h, mask=m, out_inv_scale=inv, int8_out=True)
            wq = packed_attention_int8_masked_plain(q, sec, h, mask=m, out_inv_scale=inv,
                                                    int8_out=True)
            e_b, same, _ = _int8_bars("int8-attn-kernels", f"K9 int8 [8,816,2304] {label}",
                                      got, want, gq, wq)
            if m is soft:
                err, args = e_b, (inv, gq, same)
            else:  # the fully masked row is mean(V): s_v times the mean of v
                mean = q[0, :, 2 * d:].float().mean(0) * sec[2]
                _check("int8-attn-kernels", "K9 bool mask: the fully masked row vs mean(V)",
                       max_err(got[0, 5], mean), K3_BF16_REL_TOL * want.float().abs().max().item())
        inv, gq, same = args
        routes = route_counts()["K9"]
        log(f"[int8-attn-kernels] K9 at [8,816,2304]: launches by route {routes}")
        if routes != {"wgmma": 4, "mma.sync": 0, "cuda_cores": 0}:
            raise AssertionError(f"K9 at [8,816,2304]: launches by route {routes}")
        ms, plain_ms = race(
            lambda: packed_attention_int8_masked(q, sec, h, mask=soft, out_inv_scale=inv,
                                                 int8_out=True),
            lambda: packed_attention_int8_masked_plain(q, sec, h, mask=soft,
                                                       out_inv_scale=inv, int8_out=True))
        alone = device_ms(lambda: packed_attention_int8_masked(
            q, sec, h, mask=soft, out_inv_scale=inv, int8_out=True), K39_KERNELS)
        # the yardstick: bf16 K4 on the same shape and mask, from this run
        qb, kb, vb = unpack_qkv(xf.to(torch.bfloat16), h)
        k4_ms = statistics.median(time_ms(
            lambda: fused_attention_inference(qb, kb, vb, mask=soft), runs=20))
        k4_alone = device_ms(lambda: fused_attention_inference(qb, kb, vb, mask=soft),
                             K45_KERNELS)
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

    return {"K1": _routed_count(packed_attention), **_training_counts()}


def _reset_packed_counts() -> None:
    from msvit_tpu_torch.ops.packed_attention import packed_attention, zero_counts

    zero_counts(packed_attention)
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
        route_counts, unpack_qkv, zero_counts)

    _reset_training_counts()
    zero_counts(packed_attention)
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
        k_alone = device_ms(lambda: packed_attention(x, 12), "attention_wgmma_kernel")
        f_ms, f_plain = race(lambda: packed_attention_lse(x, 12),
                             lambda: packed_attention_lse_plain(x, 12))
        b_ms, b_plain = race(lambda: packed_attention_bwd(x, None, wo, wl, gr, 12),
                             lambda: packed_attention_bwd_plain(x, None, wo, wl, gr, 12))
        qkv = unpack_qkv(x, 12)
        f_lib = library_ms(lambda: sdpa(*qkv))
        lib_bwd = sdpa_bwd(*qkv, gr.reshape(b, n, 12, -1).transpose(1, 2))
        b_lib = library_ms(lib_bwd)
        # the library calls by device time: every kernel of the call
        f_lib_dev = device_profile(lambda: sdpa(*qkv), r"^$", 0)[0]
        b_lib_dev = device_profile(lib_bwd, r"^$", 0)[0]
    torch.cuda.synchronize()
    dh = d3 // 36
    f_ops, b_ops = (attn_ops(b, 12, n, n, dh, k) for k in (2, 5))
    k_bound = bound([x], [wo], f_ops, torch.bfloat16)
    f_bound = bound([x], [wo, wl], f_ops, torch.bfloat16)
    b_bound = bound([x, wo, wl, gr], [x], b_ops, torch.bfloat16)
    shape = list(GROUPED_SHAPE)
    log(f"[{tag}] K1 (for K8a) bf16 {shape}: kernel {k_ms!r} ms, plain {k_plain!r} ms, "
        f"library (scaled_dot_product_attention) {f_lib!r} ms, bound {k_bound}; "
        f"{rate(f_ops, k_ms, k_bound)} (median of 20, CUDA events; {smi}); the kernel "
        f"alone {k_alone!r} ms (device time, torch.profiler; "
        f"{rate(f_ops, k_alone, k_bound)})")
    log(f"[{tag}] K1-lse (for K8a, with_lse) bf16 {shape}: kernel {f_ms!r} ms, plain "
        f"{f_plain!r} ms, library (scaled_dot_product_attention) {f_lib!r} ms (device time "
        f"{f_lib_dev!r} ms), bound {f_bound}; {rate(f_ops, f_ms, f_bound)} (median of 20, "
        f"CUDA events; {smi})")
    log(f"[{tag}] K2 (for K8b) bf16 {shape}: kernel {b_ms!r} ms, plain {b_plain!r} ms, "
        f"library (its backward) {b_lib!r} ms (device time {b_lib_dev!r} ms), bound "
        f"{b_bound}; {rate(b_ops, b_ms, b_bound)} (median of 20, CUDA events; {smi})")
    routes = route_counts()
    log(f"[{tag}] routes of the cases above {_pair_routes(routes)}, K1 {routes['K1']}; "
        f"{train_occupancy()}; "
        f"ptxas: {_ptxas_train()}")
    return {"K8a": dict(err=e_k1, ms=k_ms, plain_ms=k_plain, library_ms=f_lib,
                        library_device_ms=f_lib_dev, kernel_alone_ms=k_alone, **k_bound),
            "K8a-lse": dict(err=e_fwd, ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                            library_device_ms=f_lib_dev, **f_bound),
            "K8b": dict(err=e_bwd, ms=b_ms, plain_ms=b_plain, library_ms=b_lib,
                        library_device_ms=b_lib_dev, **b_bound)}


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


# ------------------------------------------------------------ PR 12 phases


def interp_phase(dev, smi: str) -> None:
    """ViT-B/16 from its 224-px table served at 384 px (24 x 24 patches, 577
    tokens: the table resampled by `interpolate_pos_embed` in every
    forward): the bf16 forward (K1 in 12 layers) and the int8 apply
    (calibrated at 384: K3 in 12 layers), each against the plain attention
    path on the same weights; ms/batch at bs16."""
    from msvit_tpu_torch.models.base import ViTModel
    from msvit_tpu_torch.models.base.quantized import calibrate_act_scales, quantized_vit_apply
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8, zero_counts)

    cfg, model, qparams, _ = vit_int8(dev)
    pix = torch.randn(16, 384, 384, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    scales = calibrate_act_scales(qparams, cfg, pix)
    plain = ViTModel(dataclasses.replace(cfg, attn_implementation="xla"), device=dev).eval()
    plain.load_state_dict(model.state_dict())

    def bf16(m):
        with torch.inference_mode():
            return m(pix)["last_hidden_state"]

    def int8(use_kernels=None):
        return quantized_vit_apply(qparams, cfg, pix, act_scales=scales, use_kernels=use_kernels)

    zero_counts(packed_attention, packed_attention_int8)
    bk = bf16(model)
    ik = int8()
    counts = {"K1": packed_attention.launches, "K3": packed_attention_int8.launches}
    bp, ip = bf16(plain), int8(use_kernels=False)
    n = 1 + (384 // cfg.patch_size) ** 2  # 577
    if not all(tuple(t.shape) == (16, n, cfg.hidden_size) and torch.isfinite(t).all()
               for t in (bk, ik, bp, ip)):
        raise AssertionError("384-px outputs: shapes or non-finite values")
    c_bf16, c_int8, c_mixed = min_cos(bk, bp), min_cos(ik, ip), min_cos(ik, bk)
    t_bf16, t_int8 = wall_ms(lambda: bf16(model)), wall_ms(int8)
    log(f"[interp] ViT-B/16 (224-px table, 196 rows) at 384 px, 577 tokens, bs16: launches "
        f"{counts}; min per-image cosine bf16 kernel vs plain path {c_bf16!r} (tolerance >= "
        f"{MS_BF16_COS!r}), int8 kernel vs plain path {c_int8!r} (tolerance >= "
        f"{MS_INT8_COS!r}), int8 vs bf16 {c_mixed!r} (tolerance >= 0.98); bf16 {t_bf16!r} "
        f"ms/batch, int8 {t_int8!r} ms/batch (10 runs after 2 of warm-up, host clock; {smi})")
    if counts != {"K1": LAYERS, "K3": LAYERS}:
        raise AssertionError(f"384-px launches {counts}, want {LAYERS} each")
    if c_bf16 < MS_BF16_COS or c_int8 < MS_INT8_COS or c_mixed < 0.98:
        raise AssertionError("384-px kernel path disagrees with the plain path")


def b8_to_448_phase(dev, smi: str, ckpt: str) -> None:
    """The ViT-B/8 pretrain checkpoint (a 784-row position table) through
    `transfer_base_to_multistate` into the 448-px multistate config (3136
    rows): the table equals `interpolate_pos_embed` of the source's, and a
    clustered bf16 forward at bs8 runs K7 in 11 layers."""
    from msvit_tpu_torch.compat.family import transfer_base_to_multistate
    from msvit_tpu_torch.models.base.vit import interpolate_pos_embed
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel
    from msvit_tpu_torch.train import restore_checkpoint
    from msvit_tpu_torch.utils.rng import Rng

    params = restore_checkpoint(ckpt)["params"]
    base = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
    cfg = ms448_config()
    model = MultiStateViTEncoderModel(cfg, device=dev).eval()
    state = transfer_base_to_multistate(base, model.state_dict(), LAYERS)
    src = base["embeddings.position_embeddings"][:, 1:]
    want = interpolate_pos_embed(src, 3136, (56, 56), has_cls=False)
    got = state["embeddings.position_embeddings"]
    same = torch.equal(got.float().cpu(), want.float().cpu())
    log(f"[b8->448] the b8 checkpoint's table {tuple(src.shape)} resampled into "
        f"{tuple(got.shape)}: equal to interpolate_pos_embed of the source {same}")
    if not same or tuple(got.shape) != (1, 3136, cfg.hidden_size):
        raise AssertionError("the transferred 448-px table is not the resampled source")
    model.load_state_dict(state)
    _reset_attn_counts()
    with torch.inference_mode():
        out = model(scene_pixels(5, size=448).to(dev), rng=Rng(3))
    _launched("b8->448 bf16 forward with clustering", {"K7": LAYERS - 1})
    _check_multistate_out("b8->448", out, cfg)
    log(f"[b8->448] num_clusters {int(out['num_clusters'])}, cluster sizes {_sizes(out)} "
        f"({smi})")


def remat_phase(dev, smi: str) -> None:
    """The ViT-B/16 bs256 train step with remat off, "" (every block
    recomputed), "dots" and "dots_no_batch" (the matrix products saved):
    the first step's gradients against remat off, K1-lse and K2 launches,
    ms/step and peak memory."""
    from msvit_tpu_torch.train import make_optimizer, train_step_fn

    batch = _batch(dev, 256, 6)
    ref, rows = None, []
    for label, kw in (("off", {}), ('""', dict(remat=True)),
                      ('"dots"', dict(remat=True, remat_policy="dots")),
                      ('"dots_no_batch"', dict(remat=True, remat_policy="dots_no_batch"))):
        model = _classifier(dev, 0, **kw)
        _reset_training_counts()
        _, g = _grads(model, batch)
        counts = _training_counts()
        want = {"K1-lse": LAYERS * (2 if kw else 1), "K2": LAYERS}
        if counts != want:
            raise AssertionError(f"remat {label}: launches {counts}, want {want}")
        if ref is None:
            ref = g
            agree = "the reference"
        else:
            c, d = cos(g, ref), (g - ref).abs().max().item() / ref.abs().max().item()
            agree = f"gradient cosine {c!r}, max |difference| {d!r} of max |grad|"
            if c < 0.999:
                raise AssertionError(f"remat {label}: gradients disagree with remat off")
        del g
        opt = make_optimizer(1e-4)
        state = opt.init(model)
        step = train_step_fn(_ce_loss, opt)
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
            raise AssertionError(f"remat {label}: non-finite loss")
        rows.append(f"{label}: {dt * 1e3!r} ms/step, peak {peak!r} GiB, launches {counts}, "
                    f"{agree}")
        del model, state, step
        torch.cuda.empty_cache()
    log(f"[remat] ViT-B/16 train step bs256 (5 steps after 2 of warm-up, host clock; peak "
        f"memory over the timed steps, weights and AdamW state included; {smi}): "
        + "; ".join(rows))


def mu_dtype_phase(dev, smi: str) -> None:
    """`Trainer` for 10 steps at bs64 with `make_optimizer(mu_dtype=
    torch.bfloat16)`: the loss falls, mu is stored in bf16, the state's
    bytes against the fused AdamW's f32 moments, K1-lse and K2 launched,
    and a fresh Trainer restores step 10 and takes step 11 bit for bit."""
    from msvit_tpu_torch.train import Trainer, make_optimizer, train_step_fn

    batch = _batch(dev, 64, 4)
    sched = warmup_cosine(5e-4, 3, 10)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mu_") as tmp:
        def trainer(model):
            return Trainer(_ce_loss, make_optimizer(sched, weight_decay=0.05,
                                                    mu_dtype=torch.bfloat16), model,
                           checkpoint_dir=os.path.join(tmp, "ckpt"), save_every=5,
                           metrics_path=os.path.join(tmp, "metrics.jsonl"), log_every=1,
                           monitor=True)

        tr = trainer(_classifier(dev, 0))
        _reset_training_counts()
        t0 = time.perf_counter()
        tr.fit(itertools.repeat(batch), num_steps=10, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _training_counts()
        losses = [r["loss"] for r in _metrics(tmp)]
        st = tr.opt_state
        dtypes = {str(t.dtype) for t in st.mu} | {str(t.dtype) for t in st.nu}
        bf16_bytes = sum(t.numel() * t.element_size() for t in st.mu + st.nu)
        fused = _classifier(dev, 0)
        opt = make_optimizer(1e-4)
        fstate = opt.init(fused)
        train_step_fn(_ce_loss, opt)(fused, fstate, batch, None)
        f32_bytes = sum(t.numel() * t.element_size() for s in fstate.adamw.state.values()
                        for t in s.values() if t.dim() > 0)
        del fused, fstate
        log(f"[mu_dtype] 10 Trainer steps at bs64 with a bf16 first moment in {wall:.2f} s "
            f"(checkpoints at 5 and 10, host reads every step); losses {losses}; launches "
            f"{launches}; moment dtypes {sorted(dtypes)}; optimizer state {bf16_bytes} bytes "
            f"(bf16 mu + f32 nu) against {f32_bytes} (the fused AdamW's f32 moments), "
            f"{bf16_bytes / f32_bytes!r} of it ({smi})")
        if len(losses) != 10 or not all(math.isfinite(v) for v in losses):
            raise AssertionError("a mu_dtype training loss is missing or not finite")
        if not losses[-1] < losses[0]:
            raise AssertionError("the mu_dtype loss did not fall over 10 steps")
        if launches != {"K1-lse": 10 * LAYERS, "K2": 10 * LAYERS}:
            raise AssertionError(f"mu_dtype launches {launches}")
        if not all(t.dtype == torch.bfloat16 for t in st.mu) or bf16_bytes >= f32_bytes:
            raise AssertionError(f"mu_dtype state: dtypes {dtypes}, {bf16_bytes} bytes")
        fresh = trainer(_classifier(dev, 1))
        step = fresh.restore()
        same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                     tr.model.state_dict().values()))
        same &= all(torch.equal(a, b) for a, b in zip(fresh.opt_state.mu + fresh.opt_state.nu,
                                                      st.mu + st.nu))
        for t in (tr, fresh):
            t.ckpt = t.metrics = None
            t.fit(itertools.repeat(batch), num_steps=11, seed=0)
        same11 = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                       tr.model.state_dict().values()))
        log(f"[mu_dtype] fresh Trainer restored step {step}: params, mu and nu equal {same}; "
            f"step 11 from both equal {same11}")
        if step != 10 or not (same and same11):
            raise AssertionError("the mu_dtype resume is not bit for bit")
        del tr, fresh


def _check_global_partition(label: str, out: dict, cfg) -> None:
    """The outputs of a clustering whose child ids are not compacted (FPS,
    axis-align: ids are center or axis numbers): shapes, finite values,
    ids in [0, C), and num_clusters the count of distinct ids."""
    lh, tx, ids, nc = (out[k] for k in ("last_hidden_state", "cluster_tokens",
                                       "last_cluster_indices", "num_clusters"))
    b, c, d, n = MS_BATCH, cfg.max_clusters, cfg.hidden_size, cfg.num_patches
    if (tuple(lh.shape), tuple(tx.shape), tuple(ids.shape)) != ((b, n, d), (b, c, d), (b, n)):
        raise AssertionError(f"{label}: output shapes")
    if not (torch.isfinite(lh).all() and torch.isfinite(tx).all()):
        raise AssertionError(f"{label}: non-finite outputs")
    distinct = int(torch.unique(ids).numel())
    if int(ids.min()) < 0 or int(ids.max()) >= c or nc.numel() != 1 or int(nc) != distinct:
        raise AssertionError(f"{label}: ids in [{int(ids.min())}, {int(ids.max())}], "
                             f"num_clusters {nc.tolist()}, {distinct} distinct ids")


def clustering_phase(dev, smi: str) -> None:
    """Multistate serving at `bench.py`'s config with FPS and with
    axis-align clustering (ncut_dim 8, num_sample 1024, max_clusters 16):
    the int8 (K4) and bf16 (K5) forwards, valid partitions, 11 launches per
    forward, ms/batch, host syncs, device time; then `kway_ncut` and
    `compress_tokens_with_cluster_indices` at a small shape against the
    same call on the CPU."""
    from msvit_tpu_torch.models.clustering import (
        AxisAlignClusteringConfig, FPSClusteringConfig)
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales,
        quantize_multistate_params, quantized_multistate_apply)
    from msvit_tpu_torch.models.multistate.model import compress_tokens_with_cluster_indices
    from msvit_tpu_torch.ops.ncut import kway_ncut
    from msvit_tpu_torch.utils.rng import Rng

    pix = scene_pixels(2).to(dev)
    state = None
    for name, cc in (("fps", FPSClusteringConfig(ncut_dim=8, num_sample=1024,
                                                 max_clusters=MS_CLUSTERS)),
                     ("axis", AxisAlignClusteringConfig(ncut_dim=8, num_sample=1024,
                                                        max_clusters=MS_CLUSTERS))):
        cfg = multistate_config(clustering=cc)
        model = MultiStateViTEncoderModel(
            cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        qparams = quantize_multistate_params(model)
        scales = calibrate_multistate_act_scales(qparams, cfg, scene_pixels(1).to(dev), Rng(0))

        def int8():
            return quantized_multistate_apply(qparams, cfg, pix, Rng(3), act_scales=scales)

        def bf16():
            with torch.inference_mode():
                return model(pix, rng=Rng(3))

        _reset_attn_counts()
        oi = int8()
        _launched(f"clustering {name} int8", {"K4": LAYERS - 1})
        _reset_attn_counts()
        ob = bf16()
        _launched(f"clustering {name} bf16", {"K5": LAYERS - 1})
        _check_global_partition(f"{name} int8", oi, cfg)
        _check_global_partition(f"{name} bf16", ob, cfg)
        syncs = _syncs(int8)
        t_int8, t_bf16 = wall_ms(int8), wall_ms(bf16)
        attn = K45_KERNELS
        d_int8, k4 = device_profile(int8, attn, LAYERS - 1)
        d_bf16, k5 = device_profile(bf16, attn, LAYERS - 1)
        log(f"[clustering] {name}: num_clusters int8 {int(oi['num_clusters'])}, bf16 "
            f"{int(ob['num_clusters'])}; cluster sizes int8 {_sizes(oi)}; int8 {t_int8!r} "
            f"ms/batch, bf16 {t_bf16!r} ms/batch (bs8, 10 runs after 2 of warm-up, host "
            f"clock), host syncs per int8 forward {syncs}; device time per forward int8 "
            f"{d_int8!r} ms (K4 {k4 / d_int8!r} of it), bf16 {d_bf16!r} ms (K5 "
            f"{k5 / d_bf16!r} of it; torch.profiler) ({smi})")
        del model, qparams, scales, oi, ob
        torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(2)
    basis = torch.linalg.qr(torch.randn(5, 5, generator=g))[0]
    x = basis[torch.randint(0, 5, (200,), generator=g)] + 0.2 * torch.randn(200, 5, generator=g)
    oh_c, r_c = kway_ncut(x)
    oh_d, r_d = kway_ncut(x.to(dev))
    q, wk, bk = (torch.randn(s, generator=g) for s in ((2, 2, 6, 4), (8, 2, 4), (2, 4)))
    probs = torch.softmax(torch.randn(2, 2, 6, 6, generator=g), -1)
    ci = torch.stack([torch.randperm(6, generator=g) % 3 for _ in range(2)])
    t_c = compress_tokens_with_cluster_indices(q, wk, bk, probs, ci, 3, 4)
    t_d = compress_tokens_with_cluster_indices(*(t.to(dev) for t in (q, wk, bk, probs, ci)),
                                               3, 4)
    e_r, e_t = max_err(r_d.cpu(), r_c), max_err(t_d.cpu(), t_c)
    log(f"[clustering] kway_ncut [200, 5] on the card vs the CPU: one-hot equal "
        f"{torch.equal(oh_d.cpu(), oh_c)}, rotation max abs err {e_r!r} (tolerance 1e-4); "
        f"compress_tokens_with_cluster_indices [2,2,6,4] -> [2,3,8]: max abs err {e_t!r} "
        f"(tolerance 1e-4)")
    if not torch.equal(oh_d.cpu(), oh_c) or e_r > 1e-4 or e_t > 1e-4:
        raise AssertionError("kway_ncut or the TX compression disagrees with the CPU")


def _all_counts() -> dict:
    from msvit_tpu_torch.ops.packed_attention import packed_attention, packed_attention_int8

    return {**_attn_counts(), **_training_counts(), **_ms_train_counts(),
            "K1": _routed_count(packed_attention), "K3": _routed_count(packed_attention_int8)}


def _reset_all_counts() -> None:
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8, zero_counts)

    _reset_attn_counts()
    _reset_training_counts()
    _reset_ms_train_counts()
    zero_counts(packed_attention, packed_attention_int8)


def predictive_phase(dev, smi: str) -> None:
    """`examples.train_predictive_synthetic` at the sandbox config (ViT-B
    trunk at full width and depth, bs64, 224 px, 64-px glimpses) for 10
    steps on 256 scenes made in memory: finite, falling loss, and no
    hand-written kernel launched (N = 8 tokens under a key mask: the plain
    attention, as in JAX); the step timed, img/s, peak memory; 3 steps of
    `--losses all7`; then one batch's loss and gradients on the card
    against the same model on the CPU in f32."""
    from msvit_tpu_torch.data.synthetic import generate_batch
    from msvit_tpu_torch.examples import train_predictive_synthetic as ex
    from msvit_tpu_torch.models.predictive import PredictiveViTModel, training_loss
    from msvit_tpu_torch.settings import parity_policy
    from msvit_tpu_torch.utils.rng import Rng

    data = generate_batch(range(256), size=224)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pred_") as tmp:
        args = ex.build_parser().parse_args(["--steps", "10", "--log-every", "1", "--out", tmp,
                                             "--viz-at", ""])  # no figure on the card
        _reset_all_counts()
        t0 = time.perf_counter()
        summary = ex.train(args, data)
        wall = time.perf_counter() - t0
        counts = _all_counts()
        totals = [h["total"] for h in summary["history"]]
        log(f"[predictive] train_predictive_synthetic, the sandbox config, 10 steps at bs64 "
            f"in {wall:.1f} s (model build, first-step warm-up, host reads every step and "
            f"the mean bars included); totals {totals}; mean bars {summary['mean_bars']}; "
            f"kernel launches {counts}")
        if len(totals) != 10 or not all(math.isfinite(v) for v in totals):
            raise AssertionError("a predictive loss is missing or not finite")
        if not np.mean(totals[-3:]) < np.mean(totals[:3]):
            raise AssertionError("the predictive loss did not fall over 10 steps")
        if any(counts.values()):
            raise AssertionError(f"the predictive path launched a kernel: {counts}")

        model, _, step, state = ex.build(args)
        pix = torch.from_numpy(data["images"][:64]).to(dev).float() / 127.5 - 1.0
        gens = [torch.Generator().manual_seed(i) for i in range(7)]
        for gen in gens[:2]:  # warm-up
            step(model, state, pix, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for gen in gens[2:]:
            loss, _ = step(model, state, pix, gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not math.isfinite(loss.item()):
            raise AssertionError("predictive step-time run: non-finite loss")
        # no kernel of the port's on this path: the pattern matches none
        busy, _ = device_profile(lambda: step(model, state, pix, gens[0]), r"^$", 0)
        log(f"[predictive] train step bs64 (sandbox losses, AdamW): {dt * 1e3!r} ms/step, "
            f"{64 / dt!r} img/s, peak memory {peak!r} GiB (5 steps after 2 of warm-up, host "
            f"clock); device time per step {busy!r} ms (every kernel, copy and set summed, "
            f"torch.profiler, 3 steps after 1), {1 - busy / (dt * 1e3)!r} of the step idle "
            f"({smi})")
        del model, state, step
        torch.cuda.empty_cache()

        args7 = ex.build_parser().parse_args(["--steps", "3", "--losses", "all7",
                                              "--log-every", "1", "--out", tmp, "--viz-at", ""])
        s7 = ex.train(args7, data)
        rows = s7["history"]
        log(f"[predictive] --losses all7, 3 steps: {rows}")
        if len(rows) != 3 or len(rows[0]) != 8 or not all(
                math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError("the all7 run's losses are missing or not finite")

    # one batch in f32 on the card and on the CPU, the same weights and
    # glimpses (drawn on the CPU: a seed draws other numbers on the card)
    cfg = ex.sandbox_config(policy=parity_policy())
    tc = ex.training_config("all7")
    pix = torch.from_numpy(data["images"][:8]).float() / 127.5 - 1.0
    res, draws = {}, {}
    for d in (torch.device("cpu"), dev):
        m = PredictiveViTModel(cfg, generator=torch.Generator().manual_seed(ex.SEED), device=d)
        out = m(pix.to(d), rng=Rng(5), output_inputs=True,
                **{k: v.to(d) for k, v in draws.items()})
        draws = {"context_lengths": out["context_lengths"], "patch_config": out["input_position"]}
        err, _, _ = training_loss(m, pix.to(d), out, tc)
        err.mean().backward()
        res[d.type] = (err.mean().item(),
                       torch.cat([p.grad.flatten().cpu() for p in m.parameters()]))
        del m, out, err
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    rel_l, rel_g = abs(lg - lc) / abs(lc), ((gg - gc).norm() / gc.norm()).item()
    log(f"[predictive] one batch (bs8, all7 losses, f32, tf32 off) on the card vs the CPU: "
        f"loss {lg!r} vs {lc!r}, relative {rel_l!r} (tolerance 1e-4); gradients' relative "
        f"L2 difference {rel_g!r} (tolerance 1e-3), cosine {cos(gg, gc)!r}")
    if rel_l > 1e-4 or rel_g > 1e-3:
        raise AssertionError("the predictive loss or gradients on the card disagree with the CPU")


SS_SHAPE = (8, 12, 1361, 64)  # the depth-3 448-px subsample trunk's [B, H, N, dh]
SS_BATCH = 32  # bench.py's subsample batch
SS_DEEP_BATCH = 8


def subsample_config(**overrides):
    """`bench.py`'s `_bench_subsample` config: ViT-B (768 wide, 12 heads), 6
    layers, 224 px, patch 16, grid 4 -> x2, depth 1 (80 slots + CLS)."""
    from msvit_tpu_torch.models.subsample import SubsampleViTConfig

    cfg = SubsampleViTConfig(num_hidden_layers=6, image_size=224, patch_size=16,
                             initial_grid_size=4, multiplicative_grid_size=2, max_depth=1)
    return dataclasses.replace(cfg, **overrides)


def _check_subsample_out(label: str, out: dict, cfg, b: int) -> None:
    """Shapes, finite values, and the valid slots tiling the image exactly
    once (a split parent leaves, its children enter: the areas, 1/16 of the
    image at a root and a quarter of the parent's below, sum to 1)."""
    lh, valid, lp = out["last_hidden_state"], out["last_valid_mask"], out["log_prob"]
    if tuple(lh.shape) != (b, 1 + cfg.capacity, cfg.hidden_size) or lh.dtype != torch.float32:
        raise AssertionError(f"{label}: last_hidden_state {tuple(lh.shape)} {lh.dtype}")
    if not (torch.isfinite(lh).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"{label}: non-finite outputs")
    area = (valid.float() * cfg.children_per_split ** -out["depths"].float()).sum(-1)
    if (area / cfg.num_roots - 1.0).abs().max().item() > 1e-6:
        raise AssertionError(f"{label}: the valid slots do not tile the image once")


def subsample_phase(dev, smi: str) -> dict:
    """The subsample encoder at `bench.py`'s config (bs32), seeded weights,
    in its three modes: valid outputs, no kernel launched (81 tokens, the
    plain attention path as in JAX), ms/batch, img/s, device time, host
    syncs, peak memory.  Then the deep configuration (448 px, depth 3: 1,360
    slots + CLS, bs8) in open and freeze mode: K7 in every layer of every
    open iteration (24 launches) and of the last freeze iteration (6), the
    forward timed with K7's share; with every slot split (policy bias +20:
    one tree whatever the rounding) the kernel path against the plain
    attention path.  Then `train_subsample_synthetic` for 3 + 3 steps and
    its evaluation.  Returns the K7 launches of the deep forwards."""
    from msvit_tpu_torch.data.synthetic import generate_batch
    from msvit_tpu_torch.examples import train_subsample_synthetic as ex
    from msvit_tpu_torch.models.subsample import SubsampleViTModel
    from msvit_tpu_torch.utils.rng import Rng

    def build(cfg):
        return SubsampleViTModel(cfg, generator=torch.Generator().manual_seed(0),
                                 device=dev).eval()

    def forward(model, pix, seed=0):
        with torch.inference_mode():
            return model(pix, rng=Rng(seed))

    gen = torch.Generator().manual_seed(21)
    pix = torch.randn(SS_BATCH, 224, 224, 3, generator=gen).to(dev)
    for mode in ("open", "lock", "freeze"):
        cfg = subsample_config(nesting_mode=mode)
        model = build(cfg)
        _reset_all_counts()
        out = forward(model, pix)
        counts = _all_counts()
        _check_subsample_out(f"subsample {mode}", out, cfg, SS_BATCH)
        if any(counts.values()):
            raise AssertionError(f"subsample {mode} at 81 tokens launched {counts}")
        fn = functools.partial(forward, model, pix)
        ms = wall_ms(fn)
        busy, _ = device_profile(fn, r"^$", 0)
        syncs, peak = _syncs(fn), _peak_gib(fn)
        log(f"[subsample] bench config ({mode}, bs{SS_BATCH}, 81 tokens, 6 layers, ViT-B "
            f"width): {ms!r} ms/batch, {SS_BATCH / ms * 1e3!r} img/s (10 runs after 2 of "
            f"warm-up, host clock); device time {busy!r} ms/batch (torch.profiler, every "
            f"kernel, copy and set), {1 - busy / ms!r} of the forward idle; {syncs} host "
            f"syncs; peak memory {peak!r} GiB; valid slots per image "
            f"{out['last_valid_mask'].sum(-1).tolist()[:8]}...; no kernel launched ({smi})")
        if mode == "open":
            log(f"[subsample] bench config (open): the top kernels per forward: "
                f"{top_kernels(fn)}")
        del model, out
    torch.cuda.empty_cache()

    launches = {}
    pix = torch.randn(SS_DEEP_BATCH, 448, 448, 3, generator=gen).to(dev)
    for mode, want in (("open", 24), ("freeze", 6)):
        cfg = subsample_config(image_size=448, max_depth=3, nesting_mode=mode)
        model = build(cfg)
        _reset_all_counts()
        out = forward(model, pix)
        counts = _all_counts()
        _check_subsample_out(f"subsample 448 {mode}", out, cfg, SS_DEEP_BATCH)
        full = {k: want if k == "K7" else 0 for k in counts}
        log(f"[subsample] 448 px depth 3 ({mode}, bs{SS_DEEP_BATCH}, 1361 tokens): launches "
            f"{counts}")
        if counts != full:
            raise AssertionError(f"subsample 448 {mode}: launches {counts}, want {full}")
        launches[mode] = counts["K7"]
        fn = functools.partial(forward, model, pix)
        ms = wall_ms(fn)
        busy, k7 = device_profile(fn, "attention_wgmma_kernel", want)
        syncs, peak = _syncs(fn), _peak_gib(fn)
        # every slot split: the same tree on both paths whatever the rounding
        plain = build(dataclasses.replace(cfg, attn_implementation="xla"))
        plain.load_state_dict(model.state_dict())
        for m in (model, plain):
            m.projection.bias.data.fill_(20.0)
        ok, op = forward(model, pix, 1), forward(plain, pix, 1)
        same = torch.equal(ok["last_valid_mask"], op["last_valid_mask"])
        c = min_cos(ok["last_hidden_state"], op["last_hidden_state"])
        log(f"[subsample] 448 px depth 3 ({mode}): {ms!r} ms/batch, "
            f"{SS_DEEP_BATCH / ms * 1e3!r} img/s (host clock); device time {busy!r} ms, K7 "
            f"{k7!r} ms of it ({k7 / busy!r}), {1 - busy / ms!r} idle; {syncs} host syncs; "
            f"peak memory {peak!r} GiB; every slot split: valid masks equal {same}, min "
            f"per-image cosine of last_hidden_state, K7 vs the plain path, {c!r} (tolerance "
            f">= {MS_BF16_COS!r}) ({smi})")
        if not same or c < MS_BF16_COS:
            raise AssertionError(f"subsample 448 {mode}: the kernel path disagrees with plain")
        log(f"[subsample] 448 px depth 3 ({mode}, every slot split): the top kernels per "
            f"forward: {top_kernels(functools.partial(forward, model, pix, 1))}")
        del model, plain, out, ok, op
        torch.cuda.empty_cache()

    data = generate_batch(range(256), size=224)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ss_") as tmp:
        args = ex.build_parser().parse_args(
            ["--warmup", "3", "--steps", "3", "--eval-size", "64", "--log-every", "1",
             "--out", tmp, "--no-figure"])
        t0 = time.perf_counter()
        summary = ex.train(args, data)
        wall = time.perf_counter() - t0
    rows = summary["history"]
    phases = [r["phase"] for r in rows]
    log(f"[subsample] train_subsample_synthetic, 3 warmup + 3 REINFORCE steps at bs32 and "
        f"the evaluation on 64 held-out scenes in {wall:.1f} s: {rows}; accuracy learned / "
        f"never / always {summary['acc_learned']!r} / {summary['acc_never']!r} / "
        f"{summary['acc_always']!r}, tokens {summary['tokens_learned']!r} / "
        f"{summary['tokens_never']!r} / {summary['tokens_always']!r}")
    # phase A logs its first and last step, phase B every step
    if phases != ["warmup"] * 2 + ["reinforce"] * 3 or not all(
            math.isfinite(r["ce"]) for r in rows):
        raise AssertionError("the subsample example's losses are missing or not finite")
    if (summary["tokens_never"], summary["tokens_always"]) != (16.0, 64.0):
        raise AssertionError("the forced subsample controls kept the wrong token counts")
    return launches


def key_mask_kernel_phase(dev, smi: str) -> dict:
    """K4, K5, K5-lse, K7 and K6 with the subsample trunk's key-only mask:
    bf16 [8,12,1361,64] views of a packed QKV output and an additive
    [8,1,1,1361] mask (CLS and ~60% of the slots 0, the others -1e30, every
    slot minus log 4 x its depth: weighted tokens), read through a row
    stride of 0; each against its plain version and bit-equal to itself
    given the mask expanded to [8,1,1361,1361]; K4, K5, K7 and K6 also at
    Nq 1025 x Nk 1361 (the freeze iteration).  Then each timed through the
    wrapper beside its plain version, the library call and its bound."""
    from msvit_tpu_torch.models.subsample import build_quadtree
    from msvit_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from msvit_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_inference, fused_attention_inference_plain,
        fused_attention_lse, fused_attention_lse_plain, fused_attention_plain)
    from msvit_tpu_torch.ops.packed_attention import unpack_qkv

    b, h, n, dh = SS_SHAPE
    gen = torch.Generator().manual_seed(31)
    depth = torch.from_numpy(
        build_quadtree(subsample_config(image_size=448, max_depth=3)).depth).float()
    valid = torch.rand(b, n - 1, generator=gen) < 0.6
    key = torch.cat([torch.zeros(b, 1), torch.where(valid, 0.0, -1e30) - math.log(4) * depth],
                    dim=-1)
    mask = key[:, None, None, :].to(dev)
    x = torch.randn(b, n, 3 * h * dh, generator=gen).to(dev).to(torch.bfloat16)
    q, k, v = unpack_qkv(x, h)
    g = torch.randn(b, n, h, dh, generator=gen).to(dev).to(torch.bfloat16).transpose(1, 2)
    shape, tag = list(SS_SHAPE), "[8,12,1361,64] key-only mask [8,1,1,1361]"
    tol = K1_TOL[torch.bfloat16]
    fwd = {"K4": (fused_attention_inference, fused_attention_inference_plain),
           "K5": (fused_attention, fused_attention_plain),
           "K7": (flash_attention, flash_attention_plain)}
    res = {}
    with torch.inference_mode():
        full = mask.expand(-1, -1, n, -1).contiguous()
        for name, (fn, plain) in fwd.items():
            for label, qq, mm, fm in (("", q, mask, full),
                                      (" Nq 1025", q[:, :, :1025], mask, full[:, :, :1025])):
                got, again, want = fn(qq, k, v, mask=mm), fn(qq, k, v, mask=fm), plain(qq, k, v, mask=mm)
                torch.cuda.synchronize()
                if not (torch.isfinite(got).all() and torch.equal(got, again)):
                    raise AssertionError(f"{name} key-only{label}: non-finite, or not bit-equal "
                                         "to the expanded mask's")
                err = _check("key-mask", f"{name} bf16 {shape}{label} key-only mask",
                             max_err(got, want), tol * max(1.0, want.float().abs().max().item()))
                if not label:
                    res[name] = err
        (o, lse), (o2, lse2) = fused_attention_lse(q, k, v, mask=mask), \
            fused_attention_lse(q, k, v, mask=full)
        wo, wl = fused_attention_lse_plain(q, k, v, mask=mask)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError("K5-lse key-only: not bit-equal to the expanded mask's")
        res["K5-lse"] = _check("key-mask", f"K5-lse bf16 {shape} key-only mask", max_err(o, wo),
                               tol * max(1.0, wo.float().abs().max().item()))
        e_l = ((lse - wl).abs() / wl.abs().clamp_min(1.0)).max().item()
        _check("key-mask", "K5-lse lse (relative)", e_l, LSE_REL_TOL)
        del o2, lse2
    with torch.no_grad():
        for label, qq, gg, mm in (("", q, g, mask), (" Nq 1025", q[:, :, :1025],
                                                     g[:, :, :1025], mask)):
            ow, lw = fused_attention_lse_plain(qq, k, v, mask=mm)
            got = flash_attention_bwd(qq, k, v, ow, gg, lw, mm)
            want = flash_attention_bwd_plain(qq, k, v, ow, gg, lw, mm)
            torch.cuda.synchronize()
            err = _check("key-mask", f"K6 bf16 {shape}{label} key-only mask: dq, dk, dv",
                         max(max_err(a, w) for a, w in zip(got, want)),
                         K6_TOL[torch.bfloat16] * max(1.0, max(w.float().abs().max().item()
                                                               for w in want)))
            if not label:
                res["K6"] = err
            del got, want
    del full
    torch.cuda.empty_cache()

    out = {}
    ops = attn_ops(b, h, n, n, dh, 2)
    with torch.inference_mode():
        for name, (fn, plain) in fwd.items():
            ms, plain_ms = race(lambda: fn(q, k, v, mask=mask), lambda: plain(q, k, v, mask=mask))
            lib = library_ms(lambda: sdpa(q, k, v, mask))
            lim = bound([q, k, v, mask], [q], ops, torch.bfloat16)
            out[name] = dict(err=res[name], ms=ms, plain_ms=plain_ms, library_ms=lib, **lim)
            if name in ("K4", "K7"):
                alone = device_ms(lambda: fn(q, k, v, mask=mask), "attention_wgmma_kernel")
                lib_dev = device_profile(lambda: sdpa(q, k, v, mask), r"^$", 0)[0]
                out[name].update(kernel_alone_ms=alone, library_device_ms=lib_dev)
                log(f"[key-mask] {name} bf16 {shape} key-only mask alone: {alone!r} ms "
                    f"(device time, torch.profiler; {rate(ops, alone, lim)}); the library "
                    f"{lib_dev!r} ms device time ({smi})")
        ms, plain_ms = race(lambda: fused_attention_lse(q, k, v, mask=mask),
                            lambda: fused_attention_lse_plain(q, k, v, mask=mask))
        lim = bound([q, k, v, mask], [q, lse], ops, torch.bfloat16)
        out["K5-lse"] = dict(err=res["K5-lse"], ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms(lambda: sdpa(q, k, v, mask)), **lim)
    with torch.no_grad():
        ms, plain_ms = race(lambda: flash_attention_bwd(q, k, v, wo, g, wl, mask),
                            lambda: flash_attention_bwd_plain(q, k, v, wo, g, wl, mask))
        lib = library_ms(sdpa_bwd(q, k, v, g, mask))
    lim = bound([q, k, v, wo, g, wl, mask], [q, k, v], attn_ops(b, h, n, n, dh, 5),
                torch.bfloat16)
    out["K6"] = dict(err=res["K6"], ms=ms, plain_ms=plain_ms, library_ms=lib, **lim)
    for name, r in out.items():
        log(f"[key-mask] {name} bf16 {tag}: kernel {r['ms']!r} ms, plain {r['plain_ms']!r} "
            f"ms, library {r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']!r} of its bound (median of 20, "
            f"CUDA events; {smi})")
    return {f"{name}@key": r for name, r in out.items()}


SACCADIC_BATCH, SACCADIC_STEPS = 16, 10  # bench.py's saccadic run


def saccadic_config(**overrides):
    """`bench.py`'s `_bench_saccadic` config: ViT-B width (768, 12 heads, a
    12-layer refiner), patterns of complexity 2 (512 of them), rank 64,
    beam 64, 448 px, 128-px translation glimpses, the Cholesky matcher."""
    from msvit_tpu_torch.models.saccadic import SaccadicViTConfig

    cfg = SaccadicViTConfig(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                            num_patterns=((2, 512),), covariance_dim=64, beam_size=64,
                            image_size=448, patch_size=128, patch_config="translation",
                            pe_bias=True, matcher_solver="chol")
    return dataclasses.replace(cfg, **overrides)


def saccadic_phase(dev, smi: str) -> None:
    """The saccadic family at `bench.py`'s config, seeded weights: the
    batched lockstep run (16 images x 10 glimpses): shapes, finite values,
    no kernel launched (the matcher is dense linear algebra; the refiner's
    few-token attention the plain path, as in JAX), no host sync in the
    loop; ms/run, device time, peak memory; in f32 on 2 images the first
    glimpse's embedding, prediction and next query on the card against the
    CPU.  Then the serial controller on
    one image (16 steps at most) and `train_saccadic` for 3 steps."""
    from msvit_tpu_torch.examples import train_saccadic as ex
    from msvit_tpu_torch.models.saccadic import SaccadicViTModel, batched_saccade_run
    from msvit_tpu_torch.settings import parity_policy

    cfg = saccadic_config()
    model = SaccadicViTModel(cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
    pix = torch.randn(SACCADIC_BATCH, 448, 448, 3,
                      generator=torch.Generator().manual_seed(41)).to(dev)

    def run():
        return batched_saccade_run(model.embeddings, model.pattern, pix,
                                   num_steps=SACCADIC_STEPS)

    _reset_all_counts()
    tr = run()
    counts = _all_counts()
    b, t, d = SACCADIC_BATCH, SACCADIC_STEPS, cfg.hidden_size
    shapes = [tuple(tr[k].shape) for k in ("queries", "embeddings", "predicted", "converged")]
    if shapes != [(t, b, cfg.dof), (t, b, d), (t, b, d), (t, b)]:
        raise AssertionError(f"saccadic batched run: shapes {shapes}")
    if not all(torch.isfinite(tr[k]).all() for k in ("queries", "embeddings", "predicted")):
        raise AssertionError("saccadic batched run: non-finite values")
    if any(counts.values()):
        raise AssertionError(f"the saccadic run launched a kernel: {counts}")
    ms = wall_ms(run, runs=5)
    busy, _ = device_profile(run, r"^$", 0)
    syncs, peak = _syncs(run), _peak_gib(run)
    log(f"[saccadic] batched run, {b} images x {t} glimpses (512 patterns of complexity 2, "
        f"rank 64, beam 64, chol): {ms!r} ms/run (5 runs after 2 of warm-up, host clock); "
        f"device time {busy!r} ms/run (torch.profiler), {1 - busy / ms!r} idle; {syncs} host "
        f"syncs; peak memory {peak!r} GiB; saccades per image {tr['num_saccades'].tolist()} "
        f"({smi})")
    if syncs:
        raise AssertionError(f"the batched saccade loop synced with the host {syncs} times")
    log(f"[saccadic] batched run: the top kernels per run: {top_kernels(run)}")
    del tr
    torch.cuda.empty_cache()

    # f32, 2 images: the card against the CPU, the same weights, on what
    # one glimpse determines: its embedding, its prediction and the next
    # query.  Later glimpses are not compared: on N(0, 1) pixels a query
    # that moves by 1e-5 of the image moves the next glimpse's embedding
    # by O(1), so the two devices' roundings part the traces there.
    f32 = saccadic_config(policy=parity_policy())
    small = pix[:2].cpu()
    res = {}
    for d_ in (torch.device("cpu"), dev):
        m = SaccadicViTModel(f32, generator=torch.Generator().manual_seed(0), device=d_)
        tr = batched_saccade_run(m.embeddings, m.pattern, small.to(d_), num_steps=2)
        res[d_.type] = {"query 1": tr["queries"][1].cpu(), "embedding 0": tr["embeddings"][0].cpu(),
                        "predicted 0": tr["predicted"][0].cpu()}
        del m, tr
    errs = {k: (max_err(res["cuda"][k], res["cpu"][k])
                / max(1.0, res["cpu"][k].abs().max().item())) for k in res["cpu"]}
    log(f"[saccadic] f32, 2 images, the first glimpse on the card vs the CPU: errors relative "
        f"to max(1, max |CPU|) {errs} (tolerance 1e-4 each)")
    if max(errs.values()) > 1e-4:
        raise AssertionError("the saccadic run on the card disagrees with the CPU")

    t0 = time.perf_counter()
    out = model(pix[:1], max_trace_length=16, max_saccade_length=6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tq = out["trace"]["query"]
    log(f"[saccadic] serial controller, one image: {out['num_steps']} steps in {wall!r} s "
        f"(host clock, first call), terminal indices {out['terminal_indices']}, "
        f"{len(out['constructed_edges'])} constructed edges, trace {tq.shape}")
    if not 1 <= out["num_steps"] <= 16 or tq.shape != (out["num_steps"], cfg.dof) or \
            not np.isfinite(out["trace"]["embedding"]).all():
        raise AssertionError("the serial saccade controller's trace is malformed")
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    summary = ex.main(["--steps", "3"])
    wall = time.perf_counter() - t0
    log(f"[saccadic] train_saccadic (its config: 256 wide, 2 layers, bs8, 8 glimpses), 3 "
        f"steps in {wall:.1f} s: losses {summary['losses']}, pools {summary['hidden']} / "
        f"{summary['context']}")
    if len(summary["losses"]) != 3 or not all(math.isfinite(x) for x in summary["losses"]):
        raise AssertionError("train_saccadic's losses are missing or not finite")


# ------------------------------------------------------------- the runtime

RUNTIME_REQUESTS = 64  # q95 JPEGs at 900 x 675, decoded to 224
# the reload runs in a child process: it imports the export module (and so
# the op registrations) and must not import the model code
_RELOAD_CHILD = r"""
import json, pathlib, sys, torch
from msvit_tpu_torch.export import load_forward
from msvit_tpu_torch.ops import packed_attention as pa
d, dev = pathlib.Path(sys.argv[1]), torch.device(sys.argv[2])
state = torch.load(d / "inputs.pt", weights_only=False)  # written by chip_smoke.py
out, launches, routes = {}, {}, {}
for name in ("int8", "bf16", "bf16_bundled"):
    g = load_forward((d / f"{name}.msvx").read_bytes())
    args = () if name == "bf16_bundled" else (state["params"][name],)
    pa.zero_counts(pa.packed_attention, pa.packed_attention_int8)
    out[name] = {b: g(*args, x.to(dev)).cpu() for b, x in state["inputs"].items()}
    launches[name] = {"K1": pa.packed_attention.launches, "K3": pa.packed_attention_int8.launches}
    routes[name] = {"K1": pa.routes_of(pa.packed_attention),
                    "K3": pa.routes_of(pa.packed_attention_int8)}
models = sorted(m for m in sys.modules if m.startswith("msvit_tpu_torch.models"))
if models:
    raise SystemExit(f"the reload imported model code: {models}")
torch.save(out, d / "outputs.pt")
print("RELOAD " + json.dumps(launches))
print("ROUTES " + json.dumps(routes))
"""


def _jpeg_requests() -> list:
    """64 q95 JPEGs at 900 x 675 in memory: `generate_batch` scenes, upscaled
    bicubically (PIL), so the decoder meets edges and textures."""
    import io

    from PIL import Image

    from msvit_tpu_torch.data.synthetic import generate_batch

    scenes = generate_batch(range(2000, 2000 + RUNTIME_REQUESTS), size=224)["images"]
    blobs = []
    for im in scenes:
        buf = io.BytesIO()
        Image.fromarray(im).resize((900, 675), Image.BICUBIC).save(buf, format="JPEG",
                                                                   quality=95)
        blobs.append(buf.getvalue())
    return blobs


def _has_jpeglib() -> bool:
    """Whether g++ finds libjpeg's header (the native decoder needs it)."""
    res = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                         input="#include <cstdio>\n#include <jpeglib.h>\n",
                         capture_output=True, text=True, timeout=120)
    return res.returncode == 0


def _serve_through(int8_fn, bf16_fn, images: np.ndarray, tag: str) -> dict:
    """Phase 4's traffic through a `BatchingServer` (int8 buckets > 2, bf16
    buckets 1 and 2): a warm-up of every bucket, then the K1 and K3 counts
    set to 0, 64 lone requests and 7 bursts of 64.  Returns the server's
    `stats`, the `wall` seconds, the `lone` and `burst` img/s, the
    `launches` of the served requests alone, and the `responses` as
    (image, (features, route))."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8, zero_counts)
    from msvit_tpu_torch.serve import BatchingServer

    n = len(images)
    responses = []
    with BatchingServer(int8_fn, images[0], max_batch=64, max_wait_ms=5.0,
                        small_apply_fn=bf16_fn, small_bucket_max=2) as srv:
        t0 = time.perf_counter()
        srv.warmup()
        log(f"[{tag}] server warm-up of buckets {srv.buckets} in "
            f"{time.perf_counter() - t0:.1f} s")
        zero_counts(packed_attention, packed_attention_int8)
        t0 = time.perf_counter()
        for i in range(64):  # lone requests -> bucket 1 -> bf16
            responses.append((i % n, srv.submit(images[i % n]).result(timeout=120)))
        t_single = time.perf_counter() - t0
        t1 = time.perf_counter()
        for burst in range(7):  # bursts of 64 -> int8 buckets
            idx = [(burst * 64 + j) % n for j in range(64)]
            futs = [srv.submit(images[i]) for i in idx]
            responses += [(i, f.result(timeout=120)) for i, f in zip(idx, futs)]
        t_burst = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        launches = {"K1": _routed_count(packed_attention),
                    "K3": _routed_count(packed_attention_int8)}
        stats = srv.stats()
    return dict(stats=stats, wall=wall, lone=64 / t_single, burst=448 / t_burst,
                launches=launches, responses=responses)


def _graph_nodes(artifact: bytes) -> tuple:
    """(op nodes, `_assert_tensor_metadata` nodes) of an artifact's program:
    each runs as one Python dispatch when the reloaded graph is called."""
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(artifact)) as z:
        name = next(n for n in z.namelist() if n.startswith("program_"))
        ep = torch.export.load(io.BytesIO(z.read(name)))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return len(ops), sum("_assert_tensor_metadata" in o for o in ops)


def _analytic_vit_flops(cfg, b: int) -> float:
    """A ViT forward's GEMMs at 2 M K N (patch projection; qkv, proj, fc1,
    fc2 per layer) and its attention at 4 B N^2 D a layer."""
    d, p, n = cfg.hidden_size, cfg.patch_size, cfg.num_patches + 1
    m = b * n
    gemms = 2 * b * (n - 1) * (p * p * cfg.num_channels) * d + cfg.num_hidden_layers * (
        2 * m * d * 3 * d + 2 * m * d * d + 2 * 2 * m * d * cfg.mlp_hidden_size)
    return float(gemms + cfg.num_hidden_layers * 4 * b * n * n * d)


def runtime_phase(dev, smi: str, live_served: dict) -> dict:
    """The runtime: (a) the native decode of 64 q95 JPEGs at 900 x 675 to
    224 px (with libjpeg on the machine; else the native preprocessor on
    PIL's decode, and a line that says the decoder was not built); (b) the
    int8 (K3) and bf16 (K1) ViT-B/16 forwards exported with a polymorphic
    batch (params outside; the bf16 one also bundled), reloaded in a child
    process without model code, equal to the live model at batches 1, 2
    and 64; (c) `BatchingServer` over the reloaded artifacts, phase 4's
    traffic on the decoded requests, printed beside `live_served` (phase
    4's serving of the live model); (d) `aot_compile` of
    the int8 bs64 forward: equal to eager, its FLOPs within 1% of the
    analytic count; (e) `Trainer.fit` (ViT-B/16, bs64) fed by a
    `ResumableLoader` through `prefetch_to_device`: 6 steps straight, and 3
    steps, a checkpoint and a fresh Trainer's 3 more, the losses of steps
    4-6 bit for bit.  Returns the artifacts' K1 and K3 launches (served
    requests and the child's batches)."""
    from msvit_tpu_torch import native
    from msvit_tpu_torch.data import pipeline as tpipe
    from msvit_tpu_torch.data.resumable import IndexSampler, ResumableLoader
    from msvit_tpu_torch.export import aot_compile, export_forward, load_forward
    from msvit_tpu_torch.models.base.quantized import quantized_vit_apply
    from msvit_tpu_torch.train import Trainer, make_optimizer

    import io

    from PIL import Image

    phase_t0 = time.perf_counter()
    # ---- (a) decode ----
    blobs = _jpeg_requests()
    cfg224 = tpipe.ImagePipelineConfig(image_size=224)
    pil_rgb = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in blobs]
    calls = native.preprocess_batch.calls
    t0 = time.perf_counter()
    pre = tpipe.preprocess_images(pil_rgb, cfg224)
    t_pre = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        tpipe.preprocess_images(pil_rgb, cfg224)
        times.append(time.perf_counter() - t0)
    if native.preprocess_batch.calls != calls + 6:
        raise AssertionError("preprocess_images did not run the native preprocessor")
    numpy_pre = np.stack([(tpipe._resize_bilinear_np(a.astype(np.float32), 224, 224) / 255.0
                           - 0.5) / 0.5 for a in pil_rgb[:4]])
    pre_err = float(np.abs(pre[:4] - numpy_pre).max())
    # the native resize takes its sample positions in f32, numpy in f64: at
    # 900 -> 224 they part by ~1e-5 px, up to a few 1e-3 of a level at an
    # edge: 1e-4 normalized
    log(f"[runtime] native preprocessor (g++ -O3 -march=native), 64 PIL-decoded 900 x 675 "
        f"images -> 224: {64 / statistics.median(times)!r} img/s (host clock, median of 5 "
        f"calls, {os.cpu_count()} host cores; the first call, its build included, "
        f"{t_pre!r} s); against the numpy path max abs {pre_err!r} (tolerance 1e-4) ({smi})")
    if pre_err > 1e-4:
        raise AssertionError("the native preprocessor disagrees with the numpy path")
    requests = np.clip(np.rint((pre * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)
    if _has_jpeglib():
        calls = native.decode_resize_u8.calls, tpipe.decode_jpeg_images_u8.pil_images
        u8 = tpipe.decode_jpeg_images_u8(blobs, cfg224)  # builds the decoder: a failure raises
        if (native.decode_resize_u8.calls - calls[0],
                tpipe.decode_jpeg_images_u8.pil_images - calls[1]) != (1, 0):
            raise AssertionError("decode_jpeg_images_u8 did not take the native route")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            tpipe.decode_jpeg_images_u8(blobs, cfg224)
            times.append(time.perf_counter() - t0)
        f32 = tpipe.decode_jpeg_images(blobs, cfg224)
        mad = float(np.abs(f32 - pre).mean())
        log(f"[runtime] native decoder: 64 q95 JPEGs at 900 x 675 -> 224 px uint8, route "
            f"native (calls +1, PIL images +0); mean abs vs the PIL route {mad!r} normalized "
            f"(bar 0.05); {64 / statistics.median(times)!r} img/s (host clock, median of 5 "
            f"calls, {os.cpu_count()} host cores) ({smi})")
        if mad >= 0.05:
            raise AssertionError("the native decoder disagrees with the PIL route")
        requests = u8
    else:
        log("[runtime] the native JPEG decoder was not built: this machine has no jpeglib.h "
            "(libjpeg's header), so decode_jpeg_images(_u8) raise here as the JAX package's "
            "do; the requests are PIL's decode through the native preprocessor")
    torch.cuda.empty_cache()

    # ---- (b) export and reload ----
    cfg, model, qparams, scales = vit_int8(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    qp = {"w": qparams, "s": scales}

    def normalize(u8):
        return u8.float() / 127.5 - 1.0

    def int8_fwd(p, u8):
        return quantized_vit_apply(p["w"], cfg, normalize(u8), act_scales=p["s"])[:, 0].float()

    def bf16_fwd(p, u8):
        out = torch.func.functional_call(model, p, (normalize(u8),))
        return out["last_hidden_state"][:, 0].float()

    example = torch.from_numpy(requests[:2]).to(dev)
    arts, export_s = {}, {}
    for name, fn, p, bundle in (("int8", int8_fwd, qp, False), ("bf16", bf16_fwd, params, False),
                                ("bf16_bundled", bf16_fwd, params, True)):
        t0 = time.perf_counter()
        arts[name] = export_forward(fn, (p, example), polymorphic_batch=True, bundle_params=bundle)
        export_s[name] = time.perf_counter() - t0
    log(f"[runtime] exported ViT-B/16 @224 forwards (uint8 in, CLS f32 out, symbolic batch): "
        + ", ".join(f"{k} {len(v) / 1e6:.3f} MB in {export_s[k]:.1f} s" for k, v in arts.items())
        + f" ({smi}); graph nodes (all / dtype-metadata checks) "
        + ", ".join(f"{k} {_graph_nodes(arts[k])}" for k in ("int8", "bf16")))
    inputs = {b: torch.from_numpy(requests[np.arange(b) % len(requests)]) for b in (1, 2, 64)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        for name, art in arts.items():
            with open(os.path.join(tmp, f"{name}.msvx"), "wb") as f:
                f.write(art)
        torch.save({"inputs": inputs, "params": {"int8": qp, "bf16": params}},
                   os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", _RELOAD_CHILD, tmp, str(dev)],
                             capture_output=True,
                             text=True, timeout=600, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": ROOT})
        child_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"the reload child failed:\n{res.stderr[-4000:]}")
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("RELOAD ")][-1]
        child = json.loads(line[len("RELOAD "):])
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("ROUTES ")][-1]
        child_routes = json.loads(line[len("ROUTES "):])
        outs = torch.load(os.path.join(tmp, "outputs.pt"), weights_only=True)
    live = {}
    with torch.no_grad():
        for name, fn, p in (("int8", int8_fwd, qp), ("bf16", bf16_fwd, params)):
            live[name] = {b: fn(p, x.to(dev)).cpu() for b, x in inputs.items()}
    live["bf16_bundled"] = live["bf16"]
    equal = {name: {b: bool(torch.equal(outs[name][b], live[name][b])) for b in inputs}
             for name in outs}
    log(f"[runtime] reloaded in a child process without msvit_tpu_torch.models ({child_s:.1f} s, "
        f"interpreter start included): batches 1, 2, 64 equal to the live model on every "
        f"element {equal}; the child's launches {child} ({smi})")
    per = 3 * cfg.num_hidden_layers  # one launch a layer, 3 batch sizes
    want = {"int8": {"K1": 0, "K3": per}, "bf16": {"K1": per, "K3": 0},
            "bf16_bundled": {"K1": per, "K3": 0}}
    if child != want:
        raise AssertionError(f"the reloaded artifacts' launches {child}, want {want}")
    if not all(all(v.values()) for v in equal.values()):
        raise AssertionError("a reloaded artifact differs from the live model")

    # ---- (c) serve the reloaded artifacts, beside phase 4's live model ----
    g_int8, g_bf16 = load_forward(arts["int8"]), load_forward(arts["bf16"])

    def wire(u8):
        return torch.from_numpy(u8).to(dev)

    def live_int8(u8):
        with torch.no_grad():
            return int8_fwd(qp, wire(u8))

    def live_bf16(u8):
        with torch.no_grad():
            return bf16_fwd(params, wire(u8))

    def routed(fn, route):  # features and the route that served them
        return lambda u8: (fn(u8), torch.full((len(u8),), route, device=dev))

    served = _serve_through(routed(lambda u8: g_int8(qp, wire(u8)), 1.0),
                            routed(lambda u8: g_bf16(params, wire(u8)), 0.0), requests, "runtime")
    stats, launches = served["stats"], served["launches"]
    for name, got in (("artifact", served), ("phase 4's live model", live_served)):
        log(f"[runtime] served {name} ({got['stats']['requests']} uint8 requests): "
            f"{got['stats']['requests'] / got['wall']!r} img/s sustained; 64 lone "
            f"{got['lone']!r} img/s, 448 in bursts of 64 {got['burst']!r} img/s; latency "
            f"p50/p95/p99 {got['stats']['p50_ms']!r} / {got['stats']['p95_ms']!r} / "
            f"{got['stats']['p99_ms']!r} ms; mean batch {got['stats']['mean_batch']!r} ({smi})")
    log(f"[runtime] the artifacts' launches while serving: {launches}")
    if stats["requests"] != 512 or min(launches.values()) <= 0:
        raise AssertionError("the served artifacts missed requests or launched no kernel")
    # every response against a direct call of the live forward of its route
    # (0.05 abs, as phase 4: a direct call at another batch size may take
    # another bf16 GEMM algorithm)
    direct = {1.0: live_int8(requests).cpu(),
              0.0: torch.cat([live_bf16(requests[i:i + 1]) for i in range(len(requests))]).cpu()}
    worst = 0.0
    for img, (feat, route) in served["responses"]:
        if feat.shape != (cfg.hidden_size,) or not torch.isfinite(feat).all():
            raise AssertionError("a served response is malformed")
        worst = max(worst, max_err(feat, direct[float(route)][img]))
    log(f"[runtime] served artifact responses vs the live model's direct calls: max abs err "
        f"{worst!r} (tolerance 0.05, as phase 4) ({smi})")
    if worst > 0.05:
        raise AssertionError("served artifact responses disagree with the live model")
    del g_int8, g_bf16
    torch.cuda.empty_cache()

    # ---- (d) aot_compile ----
    x64 = inputs[64].to(dev)
    t0 = time.perf_counter()
    compiled, cost = aot_compile(int8_fwd, (qp, x64))
    aot_s = time.perf_counter() - t0
    with torch.no_grad():
        eager = int8_fwd(qp, x64)
    same = bool(torch.equal(compiled(qp, x64), eager))
    analytic = _analytic_vit_flops(cfg, 64)
    ratio = cost["flops"] / analytic
    ms_c = statistics.median(time_ms(lambda: compiled(qp, x64)))
    ms_e = statistics.median(time_ms(lambda: int8_fwd(qp, x64)))
    log(f"[runtime] aot_compile of the int8 bs64 forward in {aot_s:.1f} s: equal to eager "
        f"{same}; FlopCounterMode {cost['flops']!r} FLOPs, analytic {analytic!r} (ratio "
        f"{ratio!r}, tolerance 1%); {ms_c!r} ms per call (CUDA events, median of 10) against "
        f"eager {ms_e!r} ms ({smi})")
    if not same or abs(ratio - 1.0) > 0.01:
        raise AssertionError("aot_compile's output or its FLOP count is wrong")
    del model, qparams, scales, qp, params, compiled
    torch.cuda.empty_cache()

    # ---- (e) resume through a ResumableLoader ----
    table = np.concatenate([requests, requests[:, ::-1], requests[:, :, ::-1],
                            requests[:, ::-1, ::-1]])
    labels = np.random.default_rng(5).integers(0, 1000, len(table))

    def loader():
        def fetch(idx):
            return {"pixel_values": table[idx], "labels": labels[idx]}

        def to_f32(item):
            return {**item, "pixel_values": normalize(item["pixel_values"])}

        return ResumableLoader(IndexSampler(len(table), 64, seed=3), fetch, prefetch=2,
                               device=dev, transform=to_f32)

    def run(tmp, tag, steps, ckpt=None, resume=False):
        metrics = os.path.join(tmp, f"{tag}.jsonl")
        tr = Trainer(_ce_loss, make_optimizer(3e-4, weight_decay=0.05),
                     _classifier(dev, 1 if resume else 0), checkpoint_dir=ckpt, save_every=3,
                     metrics_path=metrics, log_every=1)
        it = loader()
        if resume:
            tr.restore(it)
        t0 = time.perf_counter()
        tr.fit(it, steps, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        it.close()
        with open(metrics) as fh:
            return [json.loads(line)["loss"] for line in fh], wall

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        _reset_training_counts()
        straight, wall = run(tmp, "straight", 6)
        counts = _training_counts()
        ckpt = os.path.join(tmp, "ckpt")
        first, _ = run(tmp, "first", 3, ckpt)
        resumed, _ = run(tmp, "resumed", 6, ckpt, resume=True)
    log(f"[runtime] Trainer fed by ResumableLoader through prefetch_to_device, ViT-B/16 bs64: "
        f"6 steps straight in {wall:.2f} s, losses {straight}; 3 steps {first}, a checkpoint, a "
        f"fresh Trainer's steps 4-6 {resumed}; bit for bit {resumed == straight[3:]}; "
        f"launches of the straight run {counts} ({smi})")
    if first != straight[:3] or resumed != straight[3:]:
        raise AssertionError("the resumed run's losses differ from the uninterrupted run's")
    if counts != {"K1-lse": 6 * LAYERS, "K2": 6 * LAYERS}:
        raise AssertionError(f"the training launches {counts}")
    log(f"[runtime] phase 32 in {time.perf_counter() - phase_t0:.1f} s ({smi})")
    reloaded = {k: sum(Launches(c[k], child_routes[n][k]) for n, c in child.items())
                for k in ("K1", "K3")}
    return {k: launches[k] + reloaded[k] for k in launches}


def int8_ab(tag: str) -> dict:
    """The int8 serving attention on the package beside this file, for an
    A/B of two trees in one call, each run from its root in turns (parent,
    change, change, parent):

        python3 -c "import chip_smoke as c; c.int8_ab('change')"

    The phases' own inputs and readouts: K3 on kernel_phase's input and K9
    on int8_attn_kernel_phase's with the soft mask of the served partition
    (the same weights, scene and draws as multistate_phase's), int8 out,
    through the wrapper (median of 20, CUDA events) and alone
    (`device_ms`), with the bound and the share of it alone; the device
    time of ms224_attn_modes_phase's int8 forward and of slice_phase's int8
    ViT-B/16 bs64 forward, and K9's and K3's part of each.  Prints one
    line, "AB " and a JSON object."""
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
    # the bound: the function's one q.k and one P.V against the int8
    # q/k/v/out bytes (K9 also the mask in bf16, as the kernel reads it)
    ops = {"K3": attn_ops(64, 12, 197, 197, 64, 2), "K9": attn_ops(MS_BATCH, 12, 816, 816, 64, 2)}
    inputs = {"K3": [q, sec], "K9": [q9, sec9, soft.to(torch.bfloat16)]}
    with torch.inference_mode():
        for k, fn in calls.items():
            res[f"{k}_ms"] = statistics.median(time_ms(fn, runs=20))
            res[f"{k}_alone_ms"] = device_ms(fn, K39_KERNELS)
            res[f"{k}_bound_ms"] = bound(inputs[k], [fn()], ops[k], torch.int8)["bound_ms"]
            res[f"{k}_share_of_bound"] = res[f"{k}_bound_ms"] / res[f"{k}_alone_ms"]
    res["ms224_int8_attn_device_ms"], res["ms224_K9_ms"] = ms224_int8_profile(cfg, run)
    del run
    vcfg, _, qparams, scales = vit_int8(dev)
    pix = wire_pixels(np.concatenate([serving_images()] * 2), dev)
    res["vit_int8_bs64_device_ms"], res["vit_K3_ms"] = int8_forward_profile(
        qparams, vcfg, scales, pix)
    print("AB " + json.dumps(res), flush=True)
    return res


def dispatch_ab(tag: str) -> dict:
    """The host cost of a K1 and a K3 wrapper call, and phase 4's serving,
    on the package beside this file, for an A/B of two trees in one call
    (parent, change, change, parent; each run from its root after this
    file is copied over the parent's own):

        python3 -c "import chip_smoke as c; c.dispatch_ab('change')"

    Host microseconds of one wrapper call at a lone request's shape
    [1,197,2304] (K1 bf16, K3 int8 with phase 4's scale tensors; median of
    200 calls, each timed alone on the host clock, no sync inside), the
    wall time of a bf16 ViT-B/16 bs1 forward with its sync (median of 50),
    and `_serve_through` of phase 4's live model (lone and burst img/s,
    p50/p99).  Prints one line, "AB " and a JSON object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.ops import packed_attention as pa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 197, 2304, generator=g).to(dev, torch.bfloat16)
    _, q, sec = int8_qkv(g, (1, 197, 2304), dev, scale=0.5)
    inv = torch.tensor(20.0, device=dev)

    def host_us(fn, n=200):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(ts) * 1e6

    with torch.inference_mode():
        res["K1_host_us"] = host_us(lambda: pa.packed_attention(qkv, 12))
        res["K3_host_us"] = host_us(lambda: pa.packed_attention_int8(
            q, sec, 12, out_inv_scale=inv, int8_out=True))
    cfg, model, qparams, scales = vit_int8(dev)
    images = serving_images()
    one = wire_pixels(images[:1], dev)

    def fwd():
        with torch.inference_mode():
            model(one)
        torch.cuda.synchronize()

    for _ in range(5):
        fwd()
    ts = []
    for _ in range(50):
        t0 = time.perf_counter()
        fwd()
        ts.append(time.perf_counter() - t0)
    res["bf16_bs1_forward_ms"] = statistics.median(ts) * 1e3

    served = _serve_through(*serving_fns(cfg, model, qparams, scales, dev), images, "ab")
    res.update(lone_img_s=served["lone"], burst_img_s=served["burst"],
               p50_ms=served["stats"]["p50_ms"], p99_ms=served["stats"]["p99_ms"],
               launches=served["launches"])
    print("AB " + json.dumps(res), flush=True)
    return res


def train_kernel_ab(tag: str) -> dict:
    """K1-lse and K2, and the two train steps that run them most, on the
    package beside this file, for an A/B of two trees in one call (parent,
    change, change, parent; each run from its root after this file is
    copied over the parent's own):

        python3 -c "import chip_smoke as c; c.train_kernel_ab('change')"

    K1-lse and K2 bf16 at [64,197,2304] and [64,785,2304] (median of 20,
    CUDA events; K2 from K1-lse's residuals and a random cotangent; then
    the kernels alone, `device_ms`: at 197 tokens the wrapper's host time
    can exceed the kernel's; `scaled_dot_product_attention` and its
    backward by device time beside them), the
    ViT-B/8 pretrain step at bs64 (`--preset b8`, the example's loss and
    optimizer, clip 1.0, uint8 batches resident on the device) and
    step_time_phase's ViT-B/16 step at bs256: ms/step over 5 steps after 2
    of warm-up (host clock, synchronized).  Prints one line, "AB " and a
    JSON object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.examples import pretrain_synthetic as ps
    from msvit_tpu_torch.models.base import ViTForImageClassification
    from msvit_tpu_torch.ops import packed_attention as pa
    from msvit_tpu_torch.train import make_optimizer, train_step_fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    g = torch.Generator().manual_seed(0)
    for shape in (MAIN_SHAPE, GROUPED_SHAPE):
        x = torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
        gr = torch.randn(*shape[:2], shape[2] // 3, generator=g).to(torch.bfloat16).to(dev)
        with torch.no_grad():
            o, lse = pa.packed_attention_lse(x, 12)
            fwd = lambda: pa.packed_attention_lse(x, 12)  # noqa: E731
            bwd = lambda: pa.packed_attention_bwd(x, None, o, lse, gr, 12)  # noqa: E731
            res[f"K1-lse_{shape[1]}_ms"] = statistics.median(time_ms(fwd, runs=20))
            res[f"K2_{shape[1]}_ms"] = statistics.median(time_ms(bwd, runs=20))
            # the library's forward and backward by device time (every kernel)
            qkv = pa.unpack_qkv(x, 12)
            res[f"K1-lse_{shape[1]}_sdpa_device_ms"] = device_profile(
                lambda: sdpa(*qkv), r"^$", 0)[0]
            res[f"K2_{shape[1]}_sdpa_device_ms"] = device_profile(
                sdpa_bwd(*qkv, gr.reshape(*shape[:2], 12, -1).transpose(1, 2)), r"^$", 0)[0]
            # the kernels alone (either tree's names: mma.sync or wgmma)
            res[f"K1-lse_{shape[1]}_alone_ms"] = device_ms(fwd, r"packed_lse_w?g?mma_kernel")
            res[f"K2_{shape[1]}_alone_ms"] = device_ms(
                bwd, r"packed_bwd_d(?:q|kv)_w?g?mma_kernel", kernels=2)
        del x, gr, o, lse

    def step_ms(model, loss, opt, batch) -> float:
        state = opt.init(model)
        step = train_step_fn(loss, opt)
        for _ in range(2):  # warm-up
            step(model, state, batch, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(model, state, batch, None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as out:
        args = _pretrain_args(out)
        model = ViTForImageClassification(ps.model_config(args), 5,
                                          generator=torch.Generator().manual_seed(0), device=dev)
        opt = make_optimizer(ps.warmup_cosine(args.lr, 1, 1000),
                             weight_decay=args.weight_decay, clip_norm=args.clip)
        batch = {"pixel_values": torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                                               dtype=torch.uint8).to(dev),
                 "labels": torch.randint(0, 5, (64,), generator=g).to(dev)}
        res["b8_pretrain_bs64_ms_per_step"] = step_ms(model, ps.loss_fn, opt, batch)
    del model, opt, batch
    torch.cuda.empty_cache()
    res["vit_b16_bs256_ms_per_step"] = step_ms(_classifier(dev, 0), _ce_loss,
                                               make_optimizer(1e-4), _batch(dev, 256, 6))
    print("AB " + json.dumps(res), flush=True)
    return res


def ab_kernel(res: dict, key: str, fn, lib, names: str, ops: float, lim: dict,
              kernels: int = 1) -> None:
    """One kernel's entries of an A/B under `key` in `res`: through its
    wrapper `fn` (median of 20, CUDA events), alone (`device_ms` of the
    kernels `names`, `kernels` launches a call), its bound `lim`, its share
    and its rate alone from `ops`, beside the library call `lib` through
    its call and by its device time (`device_profile`, every kernel of the
    call)."""
    res[f"{key}_ms"] = statistics.median(time_ms(fn, runs=20))
    res[f"{key}_alone_ms"] = device_ms(fn, names, kernels=kernels)
    res[f"{key}_share_of_bound"] = lim["bound_ms"] / res[f"{key}_alone_ms"]
    res[f"{key}_tflops_alone"] = ops / res[f"{key}_alone_ms"] / 1e9
    res[f"{key}_bound_ms"] = lim["bound_ms"]
    res[f"{key}_sdpa_ms"] = statistics.median(time_ms(lib, runs=20))
    res[f"{key}_sdpa_device_ms"] = device_profile(lib, r"^$", 0)[0]


def attention_kernel_ab(tag: str) -> dict:
    """K1 and K7, and the two forwards that run them most, on the package
    beside this file, for an A/B of two trees in one call (parent, change,
    change, parent; each run from its root after this file is copied over
    the parent's own):

        python3 -c "import chip_smoke as c; c.attention_kernel_ab('change')"

    The 448-px multistate bf16 forward with clustering (ms448_phase's
    model, scene and draws: ms/batch over 5 runs after 2 of warm-up, host
    clock; its device time and K7's part, `device_profile`) and
    slice_phase's ViT-B/16 bf16 forward at bs64 (the same); K7 bf16 at
    [8,12,3168,64] with that forward's partition's soft mask and at
    [8,12,1361,64] with key_mask_kernel_phase's key-only mask; K1 bf16 at
    [64,197,2304], [64,785,2304] and [8,1370,2304].  Each kernel through
    its wrapper (median of 20, CUDA events), alone (`device_ms`; either
    tree's kernel names) and its share of the bound, beside
    `scaled_dot_product_attention` on the same views, through its call and
    its device time (`device_profile`, every kernel of the call); at 197
    tokens also the host time of one wrapper call and of one library call
    (500 calls back to back, host clock, no synchronisation inside).  Prints
    one line, "AB " and a JSON object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.models.base import ViTModel, BaseViTConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel
    from msvit_tpu_torch.models.subsample import build_quadtree
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import packed_attention as pa
    from msvit_tpu_torch.utils.rng import Rng

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    k1_names, k7_names = "packed_mma_kernel|attention_wgmma_kernel", "flash_mma_kernel|attention_wgmma_kernel"

    def host_us(fn, calls: int = 500) -> float:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    # the dense 448 forward first: its partition gives K7's soft mask
    cfg = ms448_config()
    model = MultiStateViTEncoderModel(cfg, generator=torch.Generator().manual_seed(0),
                                      device=dev).eval()
    pix = scene_pixels(5, size=448).to(dev)

    def ms448():
        with torch.inference_mode():
            return model(pix, rng=Rng(3))

    out = ms448()
    soft = _soft(out["last_cluster_indices"], out["num_clusters"])
    res["ms448_bf16_ms_per_batch"] = wall_ms(ms448, runs=5)
    res["ms448_bf16_device_ms"], res["ms448_K7_ms"] = device_profile(ms448, k7_names, LAYERS - 1)
    del model, out
    torch.cuda.empty_cache()
    vit = ViTModel(BaseViTConfig(), generator=torch.Generator().manual_seed(0), device=dev).eval()
    vpix = wire_pixels(np.concatenate([serving_images()] * 2), dev)
    res["vit_bf16_bs64_ms_per_batch"] = wall_ms(lambda: _bf16_forward(vit, vpix), runs=5)
    res["vit_bf16_bs64_device_ms"], res["vit_K1_ms"] = device_profile(
        lambda: _bf16_forward(vit, vpix), k1_names, LAYERS)
    del vit
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(10)
    b, h, n, dh = MS448_SHAPE
    with torch.inference_mode():
        q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev)
                                .to(torch.bfloat16), h)
        ops = attn_ops(b, h, n, n, dh, 2)
        ab_kernel(res, "K7_3168", lambda: fl.flash_attention(q, k, v, mask=soft),
                  lambda: sdpa(q, k, v, soft), k7_names, ops,
                  bound([q, k, v, soft], [q], ops, torch.bfloat16))
        del q, k, v, soft
        b, h, n, dh = SS_SHAPE
        depth = torch.from_numpy(
            build_quadtree(subsample_config(image_size=448, max_depth=3)).depth).float()
        valid = torch.rand(b, n - 1, generator=g) < 0.6
        key = torch.cat([torch.zeros(b, 1),
                         torch.where(valid, 0.0, -1e30) - math.log(4) * depth], dim=-1)
        mask = key[:, None, None, :].to(dev)
        q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev)
                                .to(torch.bfloat16), h)
        ops = attn_ops(b, h, n, n, dh, 2)
        ab_kernel(res, "K7_key_1361", lambda: fl.flash_attention(q, k, v, mask=mask),
                  lambda: sdpa(q, k, v, mask), k7_names, ops,
                  bound([q, k, v, mask], [q], ops, torch.bfloat16))
        del q, k, v, mask
        for shape in (MAIN_SHAPE, GROUPED_SHAPE, (8, 1370, 2304)):
            x = torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
            qkv = pa.unpack_qkv(x, 12)
            ops = attn_ops(shape[0], 12, shape[1], shape[1], 64, 2)
            fn, lib = (lambda: pa.packed_attention(x, 12)), (lambda: sdpa(*qkv))
            ab_kernel(res, f"K1_{shape[1]}", fn, lib, k1_names, ops,
                      bound([x], [x[..., :768]], ops, torch.bfloat16))
            if shape == MAIN_SHAPE:
                res["K1_197_host_us"], res["K1_197_sdpa_host_us"] = host_us(fn), host_us(lib)
            del x, qkv
    print("AB " + json.dumps(res), flush=True)
    return res


def backward_kernel_ab(tag: str) -> dict:
    """K6 and K5 / K5-lse, and the two multistate runs that launch them, on
    the package beside this file, for an A/B of two trees in one call
    (parent, change, change, parent; each run from its root after this file
    is copied over the parent's own):

        python3 -c "import chip_smoke as c; c.backward_kernel_ab('change')"

    The bf16 224-px multistate forward with clustering (multistate_phase's
    model, scene and draws: its device time and K5's part,
    `device_profile`) and the fine-tune step (ms_train_phase's model,
    optimizer and batch: ms/step over 5 steps after 2, host clock, and its
    device time with the part of K5-lse and K6); K5 and K5-lse bf16 at
    [8,12,816,64] with that forward's partition's soft mask and at
    [8,12,1361,64] with key_mask_kernel_phase's key-only mask; K6 bf16 at
    those two (from K5-lse's residuals and a strided cotangent) and at
    [8,12,3168,64] with the soft mask of a random 9-cluster partition (K7-lse's
    residuals).  Each kernel through its wrapper (median of 20, CUDA
    events), alone (`device_ms`; either tree's kernel names) and its share
    of the bound, beside `scaled_dot_product_attention` (its backward for
    K6) on the same views, through its call and its device time
    (`device_profile`, every kernel of the call).  Prints one line, "AB "
    and a JSON object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.examples.train_multistate import loss_fn, trainable
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel
    from msvit_tpu_torch.models.subsample import build_quadtree
    from msvit_tpu_torch.ops import flash_attention as fl
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops import packed_attention as pa
    from msvit_tpu_torch.train import Trainer, make_optimizer
    from msvit_tpu_torch.utils.rng import Rng

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    bf = torch.bfloat16

    # the bf16 224-px forward first: its partition gives the soft mask
    model = MultiStateViTEncoderModel(multistate_config(),
                                      generator=torch.Generator().manual_seed(0),
                                      device=dev).eval()
    pix = scene_pixels(2).to(dev)

    def ms224():
        with torch.inference_mode():
            return model(pix, rng=Rng(3))

    out = ms224()
    soft = _soft(out["last_cluster_indices"], out["num_clusters"])
    res["ms224_bf16_ms_per_batch"] = wall_ms(ms224, runs=5)
    res["ms224_bf16_device_ms"], res["ms224_K5_ms"] = device_profile(ms224, K45_KERNELS,
                                                                      LAYERS - 1)
    del model, out
    torch.cuda.empty_cache()
    clf = ms_classifier(dev, ms_train_config())
    tr = Trainer(loss_fn, make_optimizer(1e-3, trainable=trainable), clf)
    batch = (pix, torch.arange(MS_BATCH, device=dev) % MS_LABELS)
    step = [0]

    def one_step():
        step[0] += 1
        tr.fit(itertools.repeat(batch), num_steps=step[0], seed=0)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    res["finetune_ms_per_step"] = (time.perf_counter() - t0) / 5 * 1e3
    res["finetune_device_ms"], res["finetune_K5-lse_K6_ms"] = device_profile(
        one_step, f"{K45_KERNELS}|{K6_KERNELS}", 3 * (LAYERS - 1))
    del clf, tr, batch
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(12)
    b, h, n, dh = MS_SHAPE
    depth = torch.from_numpy(
        build_quadtree(subsample_config(image_size=448, max_depth=3)).depth).float()
    nk = SS_SHAPE[2]
    valid = torch.rand(b, nk - 1, generator=g) < 0.6
    key = torch.cat([torch.zeros(b, 1), torch.where(valid, 0.0, -1e30) - math.log(4) * depth],
                    dim=-1)[:, None, None, :].to(dev)
    ids = torch.randint(0, 9, (b, MS448_SHAPE[2] - 2 * MS_CLUSTERS), generator=g).to(dev)
    for label, n, mask in (("816", MS_SHAPE[2], soft), ("key_1361", nk, key),
                           ("3168", MS448_SHAPE[2], None)):
        if mask is None:
            mask = _soft(ids, 9)
        q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev).to(bf), h)
        gr = torch.randn(b, n, h, dh, generator=g).to(dev).to(bf).transpose(1, 2)
        f_ops, b_ops = attn_ops(b, h, n, n, dh, 2), attn_ops(b, h, n, n, dh, 5)
        with torch.no_grad():
            if label != "3168":
                ab_kernel(res, f"K5_{label}", lambda: fa.fused_attention(q, k, v, mask=mask),
                          lambda: sdpa(q, k, v, mask), K45_KERNELS, f_ops,
                          bound([q, k, v, mask], [q], f_ops, bf))
                o, lse = fa.fused_attention_lse(q, k, v, mask=mask)
                ab_kernel(res, f"K5-lse_{label}",
                          lambda: fa.fused_attention_lse(q, k, v, mask=mask),
                          lambda: sdpa(q, k, v, mask), K45_KERNELS, f_ops,
                          bound([q, k, v, mask], [o, lse], f_ops, bf))
            else:
                o, lse = fl.flash_attention_lse(q, k, v, mask=mask)
            ab_kernel(res, f"K6_{label}",
                      lambda: fl.flash_attention_bwd(q, k, v, o, gr, lse, mask),
                      sdpa_bwd(q, k, v, gr, mask), K6_KERNELS, b_ops,
                      bound([q, k, v, o, gr, lse, mask], [q, k, v], b_ops, bf), kernels=2)
        del q, k, v, gr, o, lse, mask
        torch.cuda.empty_cache()
    print("AB " + json.dumps(res), flush=True)
    return res


def serving_kernel_ab(tag: str) -> dict:
    """K4 and K10, and the two serving forwards that run them, on the
    package beside this file, for an A/B of two trees in one call (parent,
    change, change, parent; each run from its root after this file is
    copied over the parent's own):

        python3 -c "import chip_smoke as c; c.serving_kernel_ab('change')"

    The int8 224-px multistate forward with clustering (`ms224_int8`:
    multistate_phase's weights, scales, scene and draws; K4 in 11 layers)
    and the banded 448-px bf16 forward with clustering (ms448_phase's
    weights, scene and draws; K10 in 11 layers): ms/batch over 5 runs after
    2 of warm-up (host clock), device time and the kernel's part
    (`device_profile`).  K4 bf16 at [8,12,816,64] with the int8 forward's
    partition's soft mask and at [8,12,1361,64] with key_mask_kernel_phase's
    key-only mask; K10 bf16 on the token rows of the banded forward's
    partition ([8,32+3136,2304]), of the int8 224 forward's ([8,32+784,2304])
    and of one cluster, the q third pre-scaled; K1 on that one cluster's
    3136 token rows (the same pipeline with no segment compare).  Each
    through its wrapper
    (median of 20, CUDA events), alone (`device_ms`; either tree's kernel
    names), its share of the bound, beside `scaled_dot_product_attention`
    (K10: over the token rows' queries, every key and the equivalent mask)
    through its call and its device time (`device_profile`, every kernel
    of the call); K10 also with the pairs its band's 64-key tiles hold over
    the pairs its partition needs.  Prints one line, "AB " and a JSON
    object."""
    smi = card()
    sys.path.insert(0, ROOT)
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel
    from msvit_tpu_torch.models.subsample import build_quadtree
    from msvit_tpu_torch.ops import banded_attention as ba
    from msvit_tpu_torch.ops import fused_attention as fa
    from msvit_tpu_torch.ops import packed_attention as pa
    from msvit_tpu_torch.utils.rng import Rng

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    res = {"tag": tag, "card": smi}
    bf = torch.bfloat16

    # the int8 224 forward first: its partition gives K4's soft mask and
    # K10's 224 partition
    cfg, run = ms224_int8(dev)
    out = run(cfg, "bf16")
    part224 = out["last_cluster_indices"]
    soft = _soft(part224, out["num_clusters"])
    res["ms224_int8_ms_per_batch"] = wall_ms(lambda: run(cfg, "bf16"), runs=5)
    res["ms224_int8_device_ms"], res["ms224_K4_ms"] = device_profile(
        lambda: run(cfg, "bf16"), K45_KERNELS, LAYERS - 1)
    del run, out
    torch.cuda.empty_cache()
    cfg = ms448_config(banded_attention=True)
    model = MultiStateViTEncoderModel(cfg, generator=torch.Generator().manual_seed(0),
                                      device=dev).eval()
    pix = scene_pixels(5, size=448).to(dev)

    def banded():
        with torch.inference_mode():
            return model(pix, rng=Rng(3))

    out = banded()
    part448 = out["last_cluster_indices"]
    res["ms448_banded_clusters"] = int(out["num_clusters"])
    res["ms448_banded_ms_per_batch"] = wall_ms(banded, runs=5)
    res["ms448_banded_device_ms"], res["ms448_K10_ms"] = device_profile(
        banded, K10_KERNELS, LAYERS - 1)
    del model, out
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(13)
    b, h, n, dh = MS_SHAPE
    with torch.inference_mode():
        q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev).to(bf), h)
        ops = attn_ops(b, h, n, n, dh, 2)
        ab_kernel(res, "K4_816", lambda: fa.fused_attention_inference(q, k, v, mask=soft),
                  lambda: sdpa(q, k, v, soft), K45_KERNELS, ops,
                  bound([q, k, v, soft], [q], ops, bf))
        b, h, n, dh = SS_SHAPE
        depth = torch.from_numpy(
            build_quadtree(subsample_config(image_size=448, max_depth=3)).depth).float()
        valid = torch.rand(b, n - 1, generator=g) < 0.6
        key = torch.cat([torch.zeros(b, 1),
                         torch.where(valid, 0.0, -1e30) - math.log(4) * depth], dim=-1)
        mask = key[:, None, None, :].to(dev)
        q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev).to(bf), h)
        ops = attn_ops(b, h, n, n, dh, 2)
        ab_kernel(res, "K4_key_1361", lambda: fa.fused_attention_inference(q, k, v, mask=mask),
                  lambda: sdpa(q, k, v, mask), K45_KERNELS, ops,
                  bound([q, k, v, mask], [q], ops, bf))
        del q, k, v, mask, soft

        h, dh = 12, 64
        pfx = 2 * MS_CLUSTERS
        for label, ids in (("448", part448), ("224", part224),
                           ("448_one", torch.zeros_like(part448))):
            cid = torch.sort(ids, dim=1, stable=True).values
            b, n = cid.shape
            x = k10_inputs(g, cid, h, dh, dev).to(bf)
            sizes, pairs, walked = k10_work(cid)
            res[f"K10_{label}_clusters"] = int((sizes.sum(0) > 0).sum())
            res[f"K10_{label}_walked_over_needed"] = walked / pairs
            ops = 4.0 * h * dh * pairs
            ab_kernel(res, f"K10_{label}", lambda: ba.token_rows(x, cid, h, MS_CLUSTERS),
                      k10_sdpa(x, cid, h), K10_KERNELS, ops,
                      bound([x, cid.to(torch.int32)], [x[:, pfx:, :h * dh]], ops, bf))
            if label == "448_one":  # K1 on the same 3136 keys: the pipeline, no compare
                xt = x[:, pfx:].contiguous()
                ops = attn_ops(b, h, n, n, dh, 2)
                ab_kernel(res, "K1_3136", lambda: pa.packed_attention(xt, h, scale=1.0),
                          lambda: F.scaled_dot_product_attention(*pa.unpack_qkv(xt, h),
                                                                 scale=1.0),
                          "packed_mma_kernel|attention_wgmma_kernel", ops,
                          bound([xt], [xt[..., :h * dh]], ops, bf))
                del xt
            del x
            torch.cuda.empty_cache()
    print("AB " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------ base extras


EX_BATCH = 64  # the ViT serving and train batch of the extras phase
EX_PRUNED = {i: [3, 7] for i in range(LAYERS)}  # two heads a layer: H 12 -> 10
EX_EXPERTS = 8
# the MoE trunk's routes on the kernel and the plain attention path: the
# share of (layer, token) top-1 routes that agree (see `moe_route`).  A
# route flips where a token's two best router logits lie within the two
# paths' bf16 difference, and a flipped token's later layers and its queue
# neighbours follow: 0.9920 measured at bs64 (NVIDIA H100 80GB HBM3, 700
# W); a wrong gate, expert or queue would agree on ~1/8 of the routes
MOE_ROUTE_AGREEMENT = 0.98


def write_hf_checkpoint(directory: str, cfg, model_type: str, seed: int) -> None:
    """An HF-layout checkpoint of `cfg`'s geometry from seeded tensors
    under HF's names: config.json beside pytorch_model.bin (`torch.save`;
    no safetensors or transformers needed).  ``model_type`` "vit" writes
    ViTModel's names, "dinov2" Dinov2Model's (norm1/2, mlp.fc1/2, layer
    scales at ``cfg.layerscale_value``)."""
    g = torch.Generator().manual_seed(seed)
    d, p, c = cfg.hidden_size, cfg.patch_size, cfg.num_channels
    f = cfg.mlp_hidden_size

    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"embeddings.cls_token": w(1, 1, d),
          "embeddings.position_embeddings": w(1, cfg.num_patches + 1, d),
          "embeddings.patch_embeddings.projection.weight": w(d, c, p, p),
          "embeddings.patch_embeddings.projection.bias": w(d),
          "layernorm.weight": torch.ones(d), "layernorm.bias": torch.zeros(d)}
    names = {"vit": ("layernorm_before", "layernorm_after", "intermediate.dense",
                     "output.dense"),
             "dinov2": ("norm1", "norm2", "mlp.fc1", "mlp.fc2")}[model_type]
    for i in range(cfg.num_hidden_layers):
        lp = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[lp + f"attention.attention.{n}.weight"] = w(d, d)
            sd[lp + f"attention.attention.{n}.bias"] = w(d)
        sd[lp + "attention.output.dense.weight"] = w(d, d)
        sd[lp + "attention.output.dense.bias"] = w(d)
        for n in names[:2]:
            sd[lp + n + ".weight"], sd[lp + n + ".bias"] = torch.ones(d), torch.zeros(d)
        sd[lp + names[2] + ".weight"], sd[lp + names[2] + ".bias"] = w(f, d), w(f)
        sd[lp + names[3] + ".weight"], sd[lp + names[3] + ".bias"] = w(d, f), w(d)
        if model_type == "dinov2":
            for n in ("layer_scale1", "layer_scale2"):
                sd[lp + n + ".lambda1"] = torch.full((d,), cfg.layerscale_value)
    hf = dict(model_type=model_type, hidden_size=d, num_hidden_layers=cfg.num_hidden_layers,
              num_attention_heads=cfg.num_attention_heads, intermediate_size=f,
              image_size=cfg.image_size, patch_size=p, num_channels=c, qkv_bias=True,
              layer_norm_eps=cfg.layer_norm_eps)
    if model_type == "dinov2":
        hf.update(mlp_ratio=cfg.mlp_ratio, layerscale_value=cfg.layerscale_value,
                  use_swiglu_ffn=False)
    os.makedirs(directory, exist_ok=True)
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump(hf, fh)


def _expect(label: str, got: dict, want: dict) -> None:
    """Fail unless the counts are `want` (kernels not named: 0)."""
    full = {k: want.get(k, 0) for k in got}
    log(f"[extras] {label}: launches {got}")
    if got != full:
        raise AssertionError(f"extras {label}: launches {got}, want {full}")


def _vit_pair(cfg, state, dev):
    """The ViT on `state` on the kernel path and on the plain attention
    path ("xla")."""
    from msvit_tpu_torch.models.base import ViTModel

    out = []
    for impl in (cfg.attn_implementation, "xla"):
        m = ViTModel(dataclasses.replace(cfg, attn_implementation=impl), device=dev).eval()
        m.load_state_dict(state)
        out.append(m)
    return out


def _bf16_forward(model, pix):
    with torch.inference_mode():
        return model(pix)["last_hidden_state"]


def _held(label: str, pairs) -> None:
    """`pairs`: (what, value, bar); fail below a bar."""
    log(f"[extras] {label}: " + "; ".join(f"{w} {c!r} (tolerance >= {t!r})"
                                          for w, c, t in pairs))
    for w, c, t in pairs:
        if not c >= t:
            raise AssertionError(f"extras {label}: {w} {c} < {t}")


def _vit_routes(label, cfg, state, dev, smi, bs, int8=True):
    """A ViT from `state`: the bf16 forward (K1 in every layer) and, with
    `int8`, the calibrated int8 apply (K3 in every layer), each against the
    plain attention path; host ms per batch and peak memory.  Returns
    (launches of the two forwards, kernel-path bf16 output)."""
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)

    g = torch.Generator().manual_seed(9)
    s = cfg.image_size
    pix = torch.randn(bs, s, s, 3, generator=g).to(dev)
    model, plain = _vit_pair(cfg, state, dev)
    _reset_all_counts()
    bk = _bf16_forward(model, pix)
    launches = _all_counts()
    pairs = [("bf16 kernel vs plain path, min per-image cosine",
              min_cos(bk, _bf16_forward(plain, pix)), MS_BF16_COS)]
    t_bf16 = wall_ms(lambda: _bf16_forward(model, pix))
    peak = _peak_gib(lambda: _bf16_forward(model, pix))
    n = 1 + (s // cfg.patch_size) ** 2
    if tuple(bk.shape) != (bs, n, cfg.hidden_size) or not torch.isfinite(bk).all():
        raise AssertionError(f"extras {label}: bf16 output {tuple(bk.shape)} or non-finite")
    msg = f"bf16 {t_bf16!r} ms/batch, peak {peak!r} GiB"
    if int8:
        qparams = quantize_vit_params(model)
        scales = calibrate_act_scales(qparams, cfg, torch.randn(bs, s, s, 3, generator=g).to(dev))

        def apply(use_kernels=None):
            return quantized_vit_apply(qparams, cfg, pix, act_scales=scales,
                                       use_kernels=use_kernels)

        _reset_all_counts()
        ik = apply()
        k3 = _all_counts()
        launches = {k: launches[k] + k3[k] for k in launches}
        pairs += [("int8 kernel vs plain path, min per-image cosine",
                   min_cos(ik, apply(use_kernels=False)), MS_INT8_COS),
                  ("int8 vs bf16, min per-image cosine", min_cos(ik, bk), 0.98)]
        t_int8 = wall_ms(apply)
        msg += f"; int8 {t_int8!r} ms/batch, peak {_peak_gib(apply)!r} GiB"
    _held(f"{label} bs{bs}, {n} tokens", pairs)
    log(f"[extras] {label} bs{bs}: {msg} (10 runs after 2 of warm-up, host clock; {smi})")
    return launches, bk


def _k1_k3_rows(dev, smi: str, res: dict) -> None:
    """K1 at [64,197,1920] (H 10 after prune_heads) and [8,1370,2304]
    (DINOv2-B/14 @518), K3 at [64,197,1920], against their plain versions
    and timed beside their library call and bound."""
    from msvit_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_int8, packed_attention_int8_plain,
        packed_attention_plain, unpack_qkv)

    g = torch.Generator().manual_seed(15)
    with torch.inference_mode():
        for key, shape, h in (("K1@H10", (EX_BATCH, 197, 1920), 10),
                              ("K1@1370", (8, 1370, 2304), 12)):
            x = torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
            out = packed_attention(x, h)
            err = _check("extras", f"K1 bf16 {list(shape)}",
                         max_err(out, packed_attention_plain(x, h)), K1_TOL[torch.bfloat16])
            ms, plain = race(lambda: packed_attention(x, h), lambda: packed_attention_plain(x, h))
            alone = device_ms(lambda: packed_attention(x, h), "attention_wgmma_kernel")
            lib = library_ms(lambda: sdpa(*unpack_qkv(x, h)))
            b, n, _ = shape
            ops = attn_ops(b, h, n, n, 64, 2)
            lim = bound([x], [out], ops, torch.bfloat16)
            log(f"[extras] K1 bf16 {list(shape)}: kernel {ms!r} ms, plain {plain!r} ms, "
                f"library {lib!r} ms, bound {lim}; {rate(ops, ms, lim)} (median of 20, CUDA "
                f"events; {smi}); the kernel alone {alone!r} ms (device time, "
                f"torch.profiler; {rate(ops, alone, lim)})")
            res[key] = dict(err=err, ms=ms, plain_ms=plain, library_ms=lib,
                            kernel_alone_ms=alone, **lim)
        shape = (EX_BATCH, 197, 1920)
        _, q, sec = int8_qkv(g, shape, dev, scale=0.5)
        got, want = packed_attention_int8(q, sec, 10), packed_attention_int8_plain(q, sec, 10)
        err = _check("extras", "K3 int8 [64,197,1920] bf16 out", max_err(got, want),
                     K3_BF16_REL_TOL * want.float().abs().max().item())
        inv = 127.0 / want.float().abs().amax()
        gq = packed_attention_int8(q, sec, 10, out_inv_scale=inv, int8_out=True)
        wq = packed_attention_int8_plain(q, sec, 10, out_inv_scale=inv, int8_out=True)
        delta = (gq.int() - wq.int()).abs()
        same = (delta == 0).float().mean().item()
        log(f"[extras] K3 int8 [64,197,1920] int8 out: max |delta| {delta.max().item()} "
            f"(tolerance 1), exactly equal {same!r} (tolerance >= 0.99)")
        if delta.max().item() > 1 or same < 0.99:
            raise AssertionError("K3 at H 10 disagrees with its plain version")
        ms, plain = race(
            lambda: packed_attention_int8(q, sec, 10, out_inv_scale=inv, int8_out=True),
            lambda: packed_attention_int8_plain(q, sec, 10, out_inv_scale=inv, int8_out=True))
        ops = attn_ops(EX_BATCH, 10, 197, 197, 64, 2)
        lim = bound([q, sec], [gq], ops, torch.int8)
        log(f"[extras] K3 int8-out [64,197,1920]: kernel {ms!r} ms, plain {plain!r} ms, no "
            f"library call, bound {lim}; {rate(ops, ms, lim)} (median of 20, CUDA events; "
            f"{smi})")
        res["K3@H10"] = dict(err=err, ms=ms, plain_ms=plain, library_ms=None, bit_equal=same,
                             **lim)


def _moe_routes(model, pix) -> tuple:
    """One bf16 forward and every MoE layer's route of each token (forward
    hooks on the MoE FFNs): (output, routes [L, B, N], the token's expert,
    -1 where it was dropped past its expert's capacity)."""
    from msvit_tpu_torch.models.base.moe import MoEFFN

    routes = []

    def hook(mod, args):
        _, expert, slot = mod.route(args[0])
        routes.append(torch.where(slot < mod.capacity(args[0].shape[-2]), expert, -1))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MoEFFN)]
    try:
        out = _bf16_forward(model, pix)
    finally:
        for h in handles:
            h.remove()
    return out, torch.stack(routes)


def _moe_loss(model, batch, gen):
    logits = model(batch["pixel_values"], generator=gen)
    aux = torch.stack(model.vit.encoder.moe_aux_loss).sum()
    return F.cross_entropy(logits, batch["labels"]) + 0.01 * aux, {"aux": aux}


def _set_config(model, cfg) -> None:
    """Give every module of the port under `model` that holds a config
    `cfg` (another attention route, MoE impl or capacity on the same
    weights, without drawing a second model)."""
    for m in model.modules():
        if hasattr(m, "config"):
            m.config = cfg


def moe_route(dev, smi: str) -> dict:
    """(c) ViT-B/16 with 8 experts a layer (dispatch, capacity factor 1.25:
    31 slots of 197 tokens): the bf16 forward at bs64 (K1) against the
    plain attention path, dispatch against dense at capacity factor 8
    (nothing drops), the share of tokens dropped; three `Trainer` steps at
    bs64 (K1-lse, K2): ms/step, peak memory, falling loss."""
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
    from msvit_tpu_torch.models.base.moe import MoEFFN
    from msvit_tpu_torch.train import Trainer, make_optimizer

    cfg = BaseViTConfig(num_experts=EX_EXPERTS, moe_impl="dispatch", moe_capacity_factor=1.25)
    clf = ViTForImageClassification(cfg, 1000, generator=torch.Generator().manual_seed(21),
                                    device=dev)
    model = clf.vit.eval()
    cap = next(m for m in model.modules() if isinstance(m, MoEFFN)).capacity(197)
    pix = _batch(dev, EX_BATCH, 22)["pixel_values"]
    _reset_all_counts()
    bk, rk = _moe_routes(model, pix)
    launches = _all_counts()
    _expect("MoE ViT-B/16 bf16 forward", launches, {"K1": LAYERS})
    drop = (rk < 0).float().mean().item()
    t_fwd = wall_ms(lambda: _bf16_forward(model, pix))
    peak = _peak_gib(lambda: _bf16_forward(model, pix))
    _set_config(model, dataclasses.replace(cfg, attn_implementation="xla"))
    bp, rp = _moe_routes(model, pix)
    nodrop = dataclasses.replace(cfg, moe_capacity_factor=float(EX_EXPERTS))
    outs = {}
    dense = dataclasses.replace(nodrop, moe_impl="dense")
    for label, c in (("dispatch", nodrop), ("dense", dense)):
        _set_config(model, c)
        outs[label] = _bf16_forward(model, pix)
    _set_config(clf, cfg)
    # top-1 routing is discrete: a token whose two best router logits lie
    # within the two attention paths' bf16 difference takes another expert
    # (or queue slot) on the plain path.  The routes are held by their
    # agreement, the features on the tokens routed alike in all 12 layers.
    same_route = (rk == rp).float().mean().item()
    alike = (rk == rp).all(0)  # [B, N]
    c_alike = min(cos(bk[i][alike[i]], bp[i][alike[i]]) for i in range(len(bk)))
    _held("MoE ViT-B/16 (E 8, capacity 31 of 197 tokens) bs64", [
        ("share of (layer, token) routes alike on the kernel and the plain path", same_route,
         MOE_ROUTE_AGREEMENT),
        ("bf16 kernel vs plain path on the tokens routed alike, min per-image cosine",
         c_alike, MS_BF16_COS),
        ("dispatch vs dense at capacity factor 8, min per-image cosine",
         min_cos(outs["dispatch"], outs["dense"]), MS_BF16_COS)])
    log(f"[extras] MoE ViT-B/16 bs64: capacity {cap} slots an expert, {drop!r} of (layer, "
        f"token) routes dropped; tokens routed alike in every layer on both paths "
        f"{alike.float().mean().item()!r}, all tokens' min per-image cosine "
        f"{min_cos(bk, bp)!r}; bf16 forward {t_fwd!r} ms/batch (10 runs after 2 of warm-up, "
        f"host clock), peak {peak!r} GiB ({smi})")
    if cap != 31 or not 0.0 <= drop < 1.0:
        raise AssertionError(f"MoE capacity {cap} or drop share {drop}")
    del outs, bk, bp
    torch.cuda.empty_cache()

    batch = _batch(dev, EX_BATCH, 23)
    tr = Trainer(_moe_loss, make_optimizer(1e-4), clf, log_every=1)
    clf.train()
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    for step in range(3):
        t0 = time.perf_counter()
        loss, aux = tr.step_fn(tr.model, tr.opt_state, batch,
                               torch.Generator().manual_seed(step))
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _expect("MoE ViT-B/16 3 Trainer steps", counts, {"K1-lse": 3 * LAYERS, "K2": 3 * LAYERS})
    log(f"[extras] MoE ViT-B/16 Trainer bs64: losses {losses} (cross-entropy + 0.01 x the "
        f"12 layers' Switch losses); ms/step {times} (host clock, the first with its "
        f"warm-up); peak memory {peak!r} GiB ({smi})")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses {losses}")
    return {k: launches[k] + counts[k] for k in launches}


def pruned_route(dev, smi: str) -> dict:
    """(d) ViT-B/16 with heads 3 and 7 of every layer removed by
    `prune_heads` (H 12 -> 10, qkv [64,197,1920]): bf16 (K1) and int8 (K3)
    against the plain attention path, and equal to `prune_heads_masked`'s
    model at H 12 within the bf16 bar."""
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.pruning import prune_heads, prune_heads_masked

    cfg = BaseViTConfig()
    full = ViTModel(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    state, pcfg = prune_heads(full, cfg, EX_PRUNED)
    if (pcfg.num_attention_heads, pcfg.head_dim) != (10, 64):
        raise AssertionError(f"pruned config {pcfg}")
    launches, bk = _vit_routes("pruned ViT-B/16 (H 10)", pcfg, state, dev, smi, EX_BATCH)
    _expect("pruned ViT-B/16 bf16 + int8", launches, {"K1": LAYERS, "K3": LAYERS})
    masked = ViTModel(cfg, device=dev).eval()
    masked.load_state_dict(prune_heads_masked(full, EX_PRUNED, cfg))
    pix = torch.randn(EX_BATCH, 224, 224, 3, generator=torch.Generator().manual_seed(9)).to(dev)
    _reset_all_counts()
    _held("pruned ViT-B/16", [("surgery (H 10) vs masked (H 12), min per-image cosine",
                               min_cos(bk, _bf16_forward(masked, pix)), MS_BF16_COS)])
    launches["K1"] += _all_counts()["K1"]
    return launches


def extras_phase(dev, smi: str) -> tuple:
    """The base extras, each route against the plain attention path:
    (a) an HF-layout `facebook/dino-vitb8`-shaped checkpoint (seeded) loaded
    by `load_pretrained_vit` into `zoo.build_config("dino-vitb8")`: bf16 at
    bs64, 785 tokens (K1) and int8 (K3); (b) the same checkpoint through
    `import_into_multistate` at `bench.py`'s multistate config: int8 (K4)
    and bf16 (K5) forwards, then 3 steps of `train_multistate --pretrained`
    (K5-lse, K6); (c) `moe_route`; (d) `pruned_route`; (e) a DINOv2-shaped
    checkpoint into `zoo.build_config("dinov2-vitb14")` at 518 px (1,370
    tokens, layer scale 1e-5), bs8 bf16 (K1); and K1 / K3 at the new shapes.
    Returns (launches per kernel, kernel rows)."""
    from msvit_tpu_torch import zoo
    from msvit_tpu_torch.compat import (
        import_into_multistate, load_pretrained_vit, load_state_dict_from)
    from msvit_tpu_torch.examples import train_multistate as tm
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales,
        quantize_multistate_params, quantized_multistate_apply)
    from msvit_tpu_torch.utils.rng import Rng

    t0 = time.perf_counter()
    launches = {k: 0 for k in _all_counts()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as tmp:
        b8 = os.path.join(tmp, "dino-vitb8")
        write_hf_checkpoint(b8, zoo.build_config("dino-vitb8"), "vit", seed=31)
        # (a)
        cfg, state = load_pretrained_vit(b8, zoo.build_config("dino-vitb8"))
        counts, _ = _vit_routes("(a) dino-vitb8", cfg, state, dev, smi, EX_BATCH)
        _expect("(a) dino-vitb8 bf16 + int8", counts, {"K1": LAYERS, "K3": LAYERS})
        add(counts)
        del state
        torch.cuda.empty_cache()

        # (b)
        sd = load_state_dict_from(b8)
        mcfg = multistate_config()
        model = MultiStateViTEncoderModel(mcfg, device=dev).eval()
        model.load_state_dict(import_into_multistate(sd, mcfg, model.state_dict()))
        got = model.state_dict()
        same = torch.equal(got["backbone.layer.3.attention.qkv.weight"].cpu(), torch.cat(
            [sd[f"encoder.layer.3.attention.attention.{n}.weight"]
             for n in ("query", "key", "value")]))
        same &= torch.equal(got["backbone.receiver_token"].cpu(), sd["embeddings.cls_token"][0, 0])
        if not same:
            raise AssertionError("the imported multistate trunk is not the checkpoint's")
        flat = multistate_config(pregeneration_period=LAYERS)  # no clustering event
        twins = {}
        for label, c in (("kernel", flat), ("plain", dataclasses.replace(
                flat, attn_implementation="xla"))):
            twins[label] = MultiStateViTEncoderModel(c, device=dev).eval()
            twins[label].load_state_dict(model.state_dict())
        qparams = quantize_multistate_params(model)
        scales = calibrate_multistate_act_scales(qparams, mcfg, scene_pixels(1).to(dev), Rng(0))
        pix = scene_pixels(2).to(dev)

        def int8(c, use_kernels=None):
            return quantized_multistate_apply(qparams, c, pix, Rng(3), act_scales=scales,
                                              use_kernels=use_kernels)

        def bf16(m):
            with torch.inference_mode():
                return m(pix, rng=Rng(3))

        _held("(b) multistate from the checkpoint, no clustering event", [
            ("bf16 kernel vs plain path, min per-image cosine",
             _agree(bf16(twins["kernel"]), bf16(twins["plain"])), MS_BF16_COS),
            ("int8 kernel vs plain path, min per-image cosine",
             _agree(int8(flat), int8(flat, use_kernels=False)), MS_INT8_COS)])
        del twins
        _reset_all_counts()
        ci = int8(mcfg)
        n_int8 = _all_counts()
        _reset_all_counts()
        cb = bf16(model)
        n_bf16 = _all_counts()
        _expect("(b) multistate int8 forward with clustering", n_int8, {"K4": LAYERS - 1})
        _expect("(b) multistate bf16 forward with clustering", n_bf16, {"K5": LAYERS - 1})
        _check_multistate_out("extras (b) int8", ci, mcfg)
        _check_multistate_out("extras (b) bf16", cb, mcfg)
        t_int8, t_bf16 = wall_ms(lambda: int8(mcfg)), wall_ms(lambda: bf16(model))
        log(f"[extras] (b) multistate bs8 with clustering: num_clusters int8 "
            f"{int(ci['num_clusters'])}, bf16 {int(cb['num_clusters'])}; int8 {t_int8!r} "
            f"ms/batch, bf16 {t_bf16!r} ms/batch, peak {_peak_gib(lambda: int8(mcfg))!r} GiB "
            f"(int8) (10 runs after 2 of warm-up, host clock; {smi})")
        add(n_int8)
        add(n_bf16)
        del model, qparams, ci, cb
        torch.cuda.empty_cache()
        _reset_all_counts()
        t1 = time.perf_counter()
        losses = tm.main(["--steps", "3", "--preset", "b8", "--pretrained", b8])
        torch.cuda.synchronize()
        counts = _all_counts()
        _expect("(b) train_multistate --pretrained, 3 steps", counts,
                {"K5-lse": 3 * (LAYERS - 1), "K6": 3 * (LAYERS - 1)})
        log(f"[extras] (b) train_multistate --preset b8 --pretrained: 3 steps in "
            f"{time.perf_counter() - t1:.1f} s (model build and import included); losses "
            f"{losses} ({smi})")
        if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train_multistate --pretrained losses {losses}")
        add(counts)
        torch.cuda.empty_cache()

        # (c), (d)
        add(moe_route(dev, smi))
        torch.cuda.empty_cache()
        add(pruned_route(dev, smi))
        torch.cuda.empty_cache()

        # (e)
        zcfg = zoo.build_config("dinov2-vitb14")
        v2 = os.path.join(tmp, "dinov2-vitb14")
        write_hf_checkpoint(v2, zcfg, "dinov2", seed=32)
        cfg, state = load_pretrained_vit(v2)
        if any(getattr(cfg, f) != getattr(zcfg, f) for f in (
                "hidden_size", "num_hidden_layers", "num_attention_heads", "patch_size",
                "image_size", "layerscale_value", "mlp_ratio", "use_swiglu_ffn")):
            raise AssertionError(f"config.json gives {cfg}, the zoo {zcfg}")
        counts, _ = _vit_routes("(e) dinov2-vitb14 @518", zcfg, state, dev, smi, 8, int8=False)
        _expect("(e) dinov2-vitb14 bf16 forward", counts, {"K1": LAYERS})
        add(counts)
        del state
    torch.cuda.empty_cache()
    res = {}
    _k1_k3_rows(dev, smi, res)
    log(f"[extras] launches of the phase {launches}; {time.perf_counter() - t0:.1f} s")
    return launches, res


# ring attention's card check: the 448-px multistate trunk's 3168 tokens, in
# 4 blocks of 792
RING_SHAPE = (8, 3168, 12, 64, 4)


def _ring_counts() -> dict:
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_lse

    return {"K7-lse": _routed_count(flash_attention_lse),
            "K6": _routed_count(flash_attention_bwd)}


def _reset_ring_counts() -> None:
    from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_lse
    from msvit_tpu_torch.ops.packed_attention import zero_counts

    zero_counts(flash_attention_lse, flash_attention_bwd)


def _flat(state: dict) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten() for t in state.values()])


def _sharded_steps(dev, mesh, base, batch, lr: float, steps: int, **mode) -> dict:
    """`steps` steps of `make_sharded_train_step` (mode: zero1 / fsdp / none)
    on a copy of `base`: losses, the first step's gradients and the last
    parameters (whole), ms per step after the first, peak GiB above what
    was held before the run (the model copy, its optimizer state and the
    steps), K1-lse and K2 launches per step."""
    import copy

    from msvit_tpu_torch.parallel.sharding import full_state_dict
    from msvit_tpu_torch.parallel.train_step import make_sharded_train_step
    from msvit_tpu_torch.train import make_optimizer
    from msvit_tpu_torch.utils.rng import fold_in

    held = torch.cuda.memory_allocated()
    model = copy.deepcopy(base)
    step, opt_state = make_sharded_train_step(
        _ce_loss, make_optimizer(lr, weight_decay=0.05), mesh, model, **mode)
    out = {"losses": [], "ms": [], "launches": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        _reset_training_counts()
        t0 = time.perf_counter()
        loss, _ = step(model, opt_state, batch, torch.Generator().manual_seed(fold_in(0, i)))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(_training_counts())
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = _flat(full_state_dict(model, grads=True))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["params"] = _flat(full_state_dict(model))
    del model, opt_state
    return out


def _trainer_steps(dev, base, batch, lr: float, steps: int) -> dict:
    """The same steps through the unsharded `Trainer`'s step function."""
    import copy

    from msvit_tpu_torch.train import Trainer, make_optimizer
    from msvit_tpu_torch.utils.rng import fold_in

    held = torch.cuda.memory_allocated()
    model = copy.deepcopy(base)
    tr = Trainer(_ce_loss, make_optimizer(lr, weight_decay=0.05), model)
    out = {"losses": [], "ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        t0 = time.perf_counter()
        loss, _ = tr.step_fn(model, tr.opt_state, batch, torch.Generator().manual_seed(
            fold_in(0, i)))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = _flat({n: p.grad for n, p in model.named_parameters()})
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["params"] = _flat(model.state_dict())
    start = _flat(base.state_dict())
    del model, tr
    return out, start


def ring_plain_f32(q, k, v, mask, g, images: int = 2) -> tuple:
    """Attention of q, k, v ``[B, N, H, dh]`` under the key mask ``[B, N]``
    and its gradients for the cotangent g, by the plain versions of K7-lse
    and K6 in f32 (the inputs' values upcast), `images` at a time.
    Returns (out, (dq, dk, dv)) ``[B, N, H, dh]`` f32."""
    from msvit_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_lse_plain)

    outs, grads = [], []
    for i in range(0, q.shape[0], images):
        qi, ki, vi, gi = (x[i:i + images].transpose(1, 2).float() for x in (q, k, v, g))
        mi = mask[i:i + images, None, None, :]
        o, lse = flash_attention_lse_plain(qi, ki, vi, mi)
        grads.append(flash_attention_bwd_plain(qi, ki, vi, o, gi, lse, mi))
        outs.append(o)
    return (torch.cat(outs).transpose(1, 2),
            tuple(torch.cat(t).transpose(1, 2) for t in zip(*grads)))


def parallel_phase(dev, smi: str) -> tuple:
    """The parallel layer on this one card, at world size 1 over NCCL (one
    card cannot hold two NCCL ranks, and gloo has no reduce-scatter or
    all-gather of CUDA tensors: multi-rank runs are the CPU tests').  An
    in-process group (a `file://` store in a temporary directory), then:
    (a) ViT-B/16 @224 at bs64 through `make_sharded_train_step` as data
    parallel, ZeRO-1 and FSDP, 3 steps each, each held against the
    `Trainer`'s unsharded step on the same weights and batch (loss, first
    gradients, parameters after 3 steps), with ms/step, peak memory and
    K1-lse / K2 launches a step; (b) the trunk with `sequence_sharding`
    through `parallelize` (tp = 1) against the plain trunk; (c) ring
    attention at [8, 3168, 12, 64] bf16 (the 448-px multistate trunk's
    tokens) in s = 4 blocks, every rank's per-block steps in one process
    (`ring_attention_single_process`, K7-lse and K6 per step) against the
    plain K7-lse and K6 in f32 and `FlashAttentionFunction` on the whole
    sequence with a padding-tail key mask that blanks the last block of
    half the images, and
    `ring_attention` itself at world size 1; timed beside dense K7; (d)
    GPipe at S = 1 with 4 microbatches on the classifier against the
    unpipelined model.  The group is destroyed at the end.  Returns
    (launches per kernel row, the phase's numbers)."""
    import torch.distributed as dist

    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.ops.flash_attention import FlashAttentionFunction, flash_attention
    from msvit_tpu_torch.parallel import distributed as pdist
    from msvit_tpu_torch.parallel.mesh import make_mesh
    from msvit_tpu_torch.parallel.pipeline import make_stage_mesh
    from msvit_tpu_torch.parallel.pipeline_vit import (
        PipelinedViTClassifier, make_pipelined_classifier_apply, shard_pipeline_params)
    from msvit_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_single_process)
    from msvit_tpu_torch.parallel.sharding import parallelize
    from msvit_tpu_torch.settings import parity_policy

    t_phase = time.perf_counter()
    launches = {"K1": 0, "K1-lse": 0, "K2": 0, "K7": 0, "K6": 0}
    res = {"card": smi, "world_size": 1, "backend": "nccl"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        pdist.initialize(init_method=f"file://{tmp}/store", world_size=1, rank=0,
                         backend="nccl")
        try:
            mesh = make_mesh(tp=1)
            # (a) the sharded train step against the Trainer's
            batch = _batch(dev, 64, 8)
            base = _classifier(dev, 9)
            lr, steps = 1e-4, 3
            ref, start = _trainer_steps(dev, base, batch, lr, steps)
            ref_move = ref["params"] - start
            res["trainer_ms_per_step"] = statistics.median(ref["ms"][1:])
            res["trainer_peak_gib"] = ref["peak_gib"]
            for name, mode in (("dp", {}), ("zero1", {"zero1": True}),
                               ("fsdp", {"fsdp": True})):
                got = _sharded_steps(dev, mesh, base, batch, lr, steps, **mode)
                g_err = (got["grads"] - ref["grads"]).abs().max().item()
                g_tol = 5e-2 * ref["grads"].abs().max().item()
                p_err = (got["params"] - ref["params"]).abs().max().item()
                move_cos = cos(got["params"] - start, ref_move)
                l_err = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
                per_step = got["launches"]
                log(f"[parallel] {name}: losses {got['losses']} (Trainer {ref['losses']}), "
                    f"first gradients max |diff| {g_err!r} (tolerance {g_tol!r}, 5% of max "
                    f"|grad|, bf16 compute; a group of one sums nothing: 0 expected), "
                    f"parameters after {steps} steps max |diff| {p_err!r} "
                    f"(tolerance {2 * lr * steps!r}, 2 lr a step: AdamW's update is at most "
                    f"~lr an element), cosine of the two runs' parameter moves "
                    f"{move_cos!r} (>= 0.99); {statistics.median(got['ms'][1:])!r} ms/step "
                    f"against the Trainer's {res['trainer_ms_per_step']!r}, peak "
                    f"{got['peak_gib']!r} GiB (Trainer {ref['peak_gib']!r}); launches a "
                    f"step {per_step}")
                if l_err > 2e-2 or g_err > g_tol or p_err > 2 * lr * steps or move_cos < 0.99:
                    raise AssertionError(f"parallel {name}: the sharded step is off the "
                                         f"Trainer's")
                if any(c != {"K1-lse": LAYERS, "K2": LAYERS} for c in per_step):
                    raise AssertionError(f"parallel {name}: launches {per_step}")
                launches["K1-lse"] += sum(c["K1-lse"] for c in per_step)
                launches["K2"] += sum(c["K2"] for c in per_step)
                res[name] = dict(ms_per_step=statistics.median(got["ms"][1:]),
                                 peak_gib=got["peak_gib"], grad_err=g_err, param_err=p_err,
                                 move_cos=move_cos, launches_per_step=per_step[-1],
                                 losses=got["losses"])
            # the Trainer again, last: the four runs in turns on one card
            again, _ = _trainer_steps(dev, base, batch, lr, steps)
            res["trainer_ms_per_step_again"] = statistics.median(again["ms"][1:])
            log(f"[parallel] the Trainer step again after the three modes: "
                f"{res['trainer_ms_per_step_again']!r} ms/step ({smi})")
            res["trainer_losses"] = ref["losses"]
            del base, ref, start, again
            torch.cuda.empty_cache()

            # (b) the trunk through the tensor/sequence-parallel code at tp = 1
            cfg = BaseViTConfig(policy=parity_policy(), sequence_sharding=True)
            plain = ViTModel(dataclasses.replace(cfg, sequence_sharding=False),
                             generator=torch.Generator().manual_seed(10), device=dev).eval()
            sharded = ViTModel(cfg, device=dev).eval()
            sharded.load_state_dict(plain.state_dict())
            parallelize(sharded, mesh)
            pix = _batch(dev, 8, 11)["pixel_values"]
            _reset_packed_counts()
            with torch.inference_mode():
                got = sharded(pix)["last_hidden_state"]
                n_k1 = _packed_counts()["K1"]
                want = plain(pix)["last_hidden_state"]
            err = max_err(got, want)
            log(f"[parallel] sequence_sharding trunk (tp 1, f32, bs8): max |diff| against "
                f"the plain trunk {err!r} (tolerance 1e-4; a group of one: 0 expected), "
                f"K1 launches {n_k1}")
            if err > 1e-4 or n_k1 != LAYERS:
                raise AssertionError("the sequence-sharded trunk is off the plain one")
            launches["K1"] += n_k1
            res["seq_trunk_err"] = err
            del plain, sharded
            torch.cuda.empty_cache()

            # (c) ring attention, 4 blocks of 792 tokens
            b, n, h, dh, s = RING_SHAPE
            g = torch.Generator().manual_seed(12)
            q, k, v, gout = (torch.randn(b, n, h, dh, generator=g).to(dev, torch.bfloat16)
                             for _ in range(4))
            mask = torch.ones(b, n, dtype=torch.bool)
            mask[: b // 2, (s - 1) * n // s:] = False  # the last block blank
            mask[b // 2:, n - n // 32:] = False
            mask = mask.to(dev)
            _reset_ring_counts()
            out, grads = ring_attention_single_process(q, k, v, s, mask, gout)
            torch.cuda.synchronize()
            ring_counts = _ring_counts()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            m4 = mask[:, None, None, :]
            with torch.enable_grad():
                dense = FlashAttentionFunction.apply(
                    qt, kt, vt, m4, dh ** -0.5, -0.7 * float(torch.finfo(torch.float32).max))
                dense_grads = torch.autograd.grad(dense, (qt, kt, vt), gout.transpose(1, 2))
            # the plain versions of K7-lse and K6 in f32 on the same values,
            # two images at a time ([2, 12, 3168, 3168] f32 scores)
            plain_out, plain_grads = ring_plain_f32(q, k, v, mask, gout)
            # the output bar: 2 bf16 steps at the largest |out| (bf16 keeps 8
            # significant bits; each block's output is rounded to bf16 before
            # the merge, and the merged output again: one step measured)
            o_tol = 2 * 2.0 ** (math.floor(math.log2(plain_out.abs().max().item())) - 7)
            o_err = max_err(out, dense.transpose(1, 2))
            p_err = max_err(out, plain_out)
            g_errs = [max_err(a, bb.transpose(1, 2)) / bb.abs().max().item()
                      for a, bb in zip(grads, dense_grads)]
            pg_errs = [max_err(a, bb) / bb.abs().max().item()
                       for a, bb in zip(grads, plain_grads)]
            log(f"[parallel] ring, {s} blocks of {n // s} at [{b},{n},{h},{dh}] bf16, tail "
                f"mask: out max |diff| against the plain K7-lse in f32 {p_err!r}, against "
                f"FlashAttentionFunction (bf16) {o_err!r} (tolerance {o_tol!r}: 2 bf16 steps "
                f"at max |out| {plain_out.abs().max().item()!r}), dq/dk/dv max |diff| / max "
                f"|grad| against the plain K6 in f32 {pg_errs}, against "
                f"FlashAttentionFunction {g_errs} (tolerance 2e-2: K6 rounds p and ds to "
                f"bf16); launches {ring_counts} (s x s: every rank's s steps)")
            if max(o_err, p_err) > o_tol or max(g_errs + pg_errs) > 2e-2:
                raise AssertionError("the ring's blocks are off dense attention")
            if ring_counts != {"K7-lse": s * s, "K6": s * s}:
                raise AssertionError(f"ring launches {ring_counts}")
            _on_wgmma("ring attention", ring_counts, ("K7-lse", "K6"))
            launches["K7"] += ring_counts["K7-lse"]
            launches["K6"] += ring_counts["K6"]
            del plain_out, plain_grads
            # world size 1 through ring_attention itself (one block)
            ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
            _reset_ring_counts()
            with torch.enable_grad():
                whole = ring_attention(ql, kl, vl, mesh, key_padding_mask=mask)
                whole_grads = torch.autograd.grad(whole, (ql, kl, vl), gout)
            torch.cuda.synchronize()
            one_counts = _ring_counts()
            w_err = max(max_err(whole, dense.transpose(1, 2)),
                        *(max_err(a, bb.transpose(1, 2))
                          for a, bb in zip(whole_grads, dense_grads)))
            log(f"[parallel] ring_attention at world size 1: max |diff| against "
                f"FlashAttentionFunction (out and grads) {w_err!r}; launches {one_counts}")
            if w_err > o_tol or one_counts != {"K7-lse": 1, "K6": 1}:
                raise AssertionError("ring_attention at world size 1 is off")
            _on_wgmma("ring_attention at world size 1", one_counts, ("K7-lse", "K6"))
            launches["K7"] += one_counts["K7-lse"]
            launches["K6"] += one_counts["K6"]
            qd, kd, vd = (x.detach() for x in (qt, kt, vt))
            big = -0.7 * float(torch.finfo(torch.float32).max)
            with torch.no_grad():
                ring_ms = statistics.median(time_ms(
                    lambda: ring_attention_single_process(q, k, v, s, mask)))
                dense_ms = statistics.median(time_ms(lambda: flash_attention(qd, kd, vd, m4)))
                lse_ms = statistics.median(time_ms(lambda: FlashAttentionFunction.apply(
                    qd, kd, vd, m4, dh ** -0.5, big)))
                top = top_kernels(lambda: ring_attention_single_process(q, k, v, s, mask))
            log(f"[parallel] ring forward, all {s} ranks' steps on one card "
                f"({s * s} K7-lse blocks and merges): {ring_ms!r} ms; dense K7 "
                f"{dense_ms!r} ms, dense K7-lse {lse_ms!r} ms ({smi}); top kernels of "
                f"the ring forward: {top}")
            res.update(ring_ms=ring_ms, ring_dense_k7_ms=dense_ms, ring_dense_k7_lse_ms=lse_ms,
                       ring_out_err=o_err, ring_grad_err=max(g_errs), ring_world1_err=w_err,
                       ring_plain_out_err=p_err, ring_plain_grad_err=max(pg_errs),
                       ring_out_tol=o_tol)
            del q, k, v, gout, qt, kt, vt, qd, kd, vd, dense, dense_grads, grads, out
            torch.cuda.empty_cache()

            # (d) GPipe, one stage, 4 microbatches
            from msvit_tpu_torch.models.base import ViTForImageClassification

            pcfg = BaseViTConfig(policy=parity_policy())
            full = ViTForImageClassification(pcfg, 1000,
                                             generator=torch.Generator().manual_seed(13))
            stage_mesh = make_stage_mesh(1)
            piped = PipelinedViTClassifier(pcfg, 1000, 1)
            piped.load_state_dict(shard_pipeline_params(stage_mesh, full.state_dict(), 1))
            full, piped = full.to(dev).eval(), piped.to(dev).eval()
            apply = make_pipelined_classifier_apply(pcfg, 1000, 1, 4, stage_mesh)
            pix = _batch(dev, 16, 14)["pixel_values"]
            _reset_packed_counts()
            with torch.inference_mode():
                logits = apply(piped, pix)
                n_k1 = _packed_counts()["K1"]
                want = full(pix)
            err = max_err(logits, want)
            log(f"[parallel] GPipe S=1, 4 microbatches of 4, ViT-B/16 f32: logits max |diff| "
                f"against the unpipelined classifier {err!r} (tolerance 1e-4), K1 launches "
                f"{n_k1} (12 a microbatch)")
            if err > 1e-4 or n_k1 != 4 * LAYERS:
                raise AssertionError("the pipelined classifier is off the sequential one")
            launches["K1"] += n_k1
            res["gpipe_err"] = err
            del full, piped
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print("parallel " + json.dumps(res), flush=True)
    return launches, res


# ------------------------------------------------------------ phase 35 ----

# The artifacts of `export_families_phase`: (name, weight set, the kernel
# its graph calls, launches of that kernel per forward).  The 224-px ones
# at `bench.py`'s multistate config; the 448-px ones at `ms448_config`; the
# subsample one at 448 px, quadtree depth 3 (1,361 tokens, open: 4 passes
# of 6 layers).
EXPORT_FAMILIES = (
    ("ms224_bf16", "ms224", "K5", LAYERS - 1),
    ("ms224_int8", "ms224q", "K4", LAYERS - 1),
    ("ms224_int8attn", "ms224q", "K9", LAYERS - 1),
    ("ms448_dense", "ms448", "K7", LAYERS - 1),
    ("ms448_banded", "ms448", "K10", LAYERS - 1),
    ("ss448", "ss448", "K7", 24),
)
EXPORT_BATCHES = (1, 2, 8)
EXPORT_SERVED = ("ms224_bf16", "ms224_int8")
EXPORT_LONE_RUNS = 5

# the export runs in a child process per artifact, all at once (a trace of
# a clustered forward takes tens of seconds of host time)
_EXPORT_CHILD = r"""
import json, pathlib, sys, time, torch
import chip_smoke as c
from msvit_tpu_torch.export import export_forward
d, name, weights, dev = pathlib.Path(sys.argv[1]), sys.argv[2], sys.argv[3], torch.device(sys.argv[4])
fn = c.family_forward(name, dev)
params = torch.load(d / f"{weights}.params.pt", weights_only=False)  # written by chip_smoke.py
example = torch.load(d / f"{name}.inputs.pt")[2].to(dev)
t0 = time.perf_counter()
art = export_forward(fn, (params, example), polymorphic_batch=True)
seconds = time.perf_counter() - t0
(d / f"{name}.msvx").write_bytes(art)
print("EXPORTED " + json.dumps({"seconds": seconds, "bytes": len(art)}), flush=True)
"""

# the reload: a child process per artifact that imports the export module
# (the op registrations) and the server, never the model code; it runs the
# batches, reports, then waits for its turn (a line on stdin) to time lone
# requests and serve, so that no other child loads the host meanwhile
_FAMILY_CHILD = r"""
import json, pathlib, sys, time, numpy as np, torch
from msvit_tpu_torch.export import load_forward
from msvit_tpu_torch.ops import banded_attention, flash_attention, fused_attention, packed_attention
from msvit_tpu_torch.serve import BatchingServer
d, name, weights, dev = pathlib.Path(sys.argv[1]), sys.argv[2], sys.argv[3], torch.device(sys.argv[4])
serve, runs = sys.argv[5] == "1", int(sys.argv[6])
wrappers = {"K4": fused_attention.fused_attention_inference, "K5": fused_attention.fused_attention,
            "K7": flash_attention.flash_attention,
            "K9": packed_attention.packed_attention_int8_masked, "K10": banded_attention.token_rows}
ROUTED = ("K4", "K5", "K7", "K9", "K10")
def reset():
    for f in wrappers.values():
        f.launches = 0
    packed_attention.zero_counts(*(wrappers[k] for k in ROUTED))
def counts():
    return {k: f.launches for k, f in wrappers.items()}
def k7_routes():  # the routes of the launches of K4, K5, K7, K9 and K10
    return {k: packed_attention.routes_of(wrappers[k]) for k in ROUTED}
params = torch.load(d / f"{weights}.params.pt", weights_only=False)  # written by chip_smoke.py
inputs = torch.load(d / f"{name}.inputs.pt")
g = load_forward((d / f"{name}.msvx").read_bytes())
def call(x):
    return [o.cpu() for o in g(params, x.to(dev))]
reset()
t0 = time.perf_counter()
outs = {b: call(x) for b, x in inputs.items()}
first_s = time.perf_counter() - t0
launches, routes = counts(), k7_routes()
torch.save(outs, d / f"{name}.outputs.pt")
models = sorted(m for m in sys.modules if m.startswith("msvit_tpu_torch.models"))
if models:
    raise SystemExit(f"the reload imported model code: {models}")
print("READY " + json.dumps({"first_calls_s": first_s, "launches": launches,
                             "k7_routes": routes}), flush=True)
sys.stdin.readline()
x1 = inputs[1]
for _ in range(2):
    call(x1)
lone = []
for _ in range(runs):
    t0 = time.perf_counter()
    call(x1)
    lone.append((time.perf_counter() - t0) * 1e3)
done = {"lone_ms": lone}
if serve:
    reqs = inputs[max(inputs)].numpy()
    direct = [call(torch.from_numpy(reqs[i:i + 1])) for i in range(len(reqs))]
    def apply(u8):
        f, nc, ids = g(params, torch.from_numpy(u8).to(dev))
        return f, nc.expand(f.shape[0]), ids
    with BatchingServer(apply, reqs[0], max_batch=len(reqs), max_wait_ms=5.0) as srv:
        srv.warmup()
        reset()
        t0 = time.perf_counter()
        alone = [(i % len(reqs), srv.submit(reqs[i % len(reqs)]).result(timeout=300))
                 for i in range(16)]
        t_alone = time.perf_counter() - t0
        bursts = []
        for _ in range(4):
            futs = [srv.submit(r) for r in reqs]
            bursts += [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.stats()
    # a response is row 0 of a batch-1 call: features [D], num_clusters, ids [N]
    equal = all(torch.equal(f, direct[i][0][0]) and torch.equal(nc, direct[i][1])
                and torch.equal(ids, direct[i][2][0]) for i, (f, nc, ids) in alone)
    valid = all(bool(torch.isfinite(f).all()) and 0 <= int(ids.min()) and int(ids.max()) < int(nc)
                for f, nc, ids in [r for _, r in alone] + bursts)
    done.update(served={"stats": stats, "launches": counts(), "k7_routes": k7_routes(),
                        "wall_s": wall,
                        "lone_img_s": 16 / t_alone, "lone_equal": equal, "valid": valid})
print("DONE " + json.dumps(done), flush=True)
"""


# the scenes' pixels (prototypes of scale 3) carried in uint8: [-8, 8] onto
# 0..255, steps of 1/16; the artifacts take uint8 and map it back
U8_RANGE = 8.0


def _u8_requests(pix: torch.Tensor) -> torch.Tensor:
    """Scene pixels as uint8 requests (`U8_RANGE`): the forwards see the
    scenes of the other phases to 1/32, so that clustering finds their
    groups."""
    x = (torch.clamp(pix, -U8_RANGE, U8_RANGE) + U8_RANGE) * (255.0 / (2 * U8_RANGE))
    return torch.round(x).to(torch.uint8)


def _from_u8(u8: torch.Tensor) -> torch.Tensor:
    return u8.float() * (2 * U8_RANGE / 255.0) - U8_RANGE


def _ms_features(out: dict, cfg) -> torch.Tensor:
    """A multistate forward's image features: the occupancy-weighted mean of
    its TX tokens (the head's input in `MultiStateViTForImageClassification`)."""
    tx = out["cluster_tokens"].float()
    occ = (F.one_hot(out["last_cluster_indices"], cfg.max_clusters).sum(1) > 0).float()
    return (tx * occ[..., None]).sum(1) / occ.sum(1, keepdim=True).clamp_min(1.0)


def family_forward(name: str, dev):
    """`fn(params, x)` of one artifact of `EXPORT_FAMILIES`: in, uint8
    requests [B, S, S, 3] (`U8_RANGE`), or for the 448-px multistate
    forwards the f32 pixels that `ms448_phase` serves (its scene's first
    event splits by a margin that the uint8 steps close: one cluster at
    every event on the card); out, the multistate forwards' (features
    [B, D] f32, num_clusters [], last_cluster_indices [B, N]) or the
    subsample forward's (CLS features [B, D] f32, last_valid_mask
    [B, 1360], log_prob [B]).  Clustering and the policy draw from
    `Rng(3)`, fixed at export.  The models are built on `dev` from seed 0
    (their weights come in `params`)."""
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, quantized_multistate_apply)
    from msvit_tpu_torch.models.subsample import SubsampleViTModel
    from msvit_tpu_torch.utils.rng import Rng

    normalize = (lambda x: x) if name.startswith("ms448") else _from_u8
    gen = torch.Generator().manual_seed(0)
    if name in ("ms224_int8", "ms224_int8attn"):
        cfg, mode = multistate_config(), "bf16" if name == "ms224_int8" else "int8"

        def fn(p, u8):
            out = quantized_multistate_apply(p["w"], cfg, normalize(u8), Rng(3),
                                             act_scales=p["s"], attn_mode=mode)
            return _ms_features(out, cfg), out["num_clusters"], out["last_cluster_indices"]
        return fn
    if name == "ss448":
        cfg = subsample_config(image_size=448, max_depth=3)
        model = SubsampleViTModel(cfg, generator=gen, device=dev).eval()

        def fn(p, u8):
            out = torch.func.functional_call(model, p, (normalize(u8),), {"rng": Rng(3)})
            return out["last_hidden_state"][:, 0], out["last_valid_mask"], out["log_prob"]
        return fn
    cfg = {"ms224_bf16": multistate_config(), "ms448_dense": ms448_config(),
           "ms448_banded": ms448_config(banded_attention=True)}[name]
    model = MultiStateViTEncoderModel(cfg, generator=gen, device=dev).eval()

    def fn(p, u8):
        out = torch.func.functional_call(model, p, (normalize(u8),), {"rng": Rng(3)})
        return _ms_features(out, cfg), out["num_clusters"], out["last_cluster_indices"]
    return fn


def _family_weights(dev) -> dict:
    """The weight sets of `EXPORT_FAMILIES`, seed 0 as the other phases':
    the 224-px encoder's parameters, its int8 weights with the scales
    calibrated on scene 1, the 448-px encoder's and the deep subsample
    model's parameters."""
    from msvit_tpu_torch.models.multistate import (
        MultiStateViTEncoderModel, calibrate_multistate_act_scales, quantize_multistate_params)
    from msvit_tpu_torch.models.subsample import SubsampleViTModel
    from msvit_tpu_torch.utils.rng import Rng

    def params(m):
        return {k: v.detach() for k, v in m.named_parameters()}

    out = {}
    cfg = multistate_config()
    m224 = MultiStateViTEncoderModel(cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev).eval()
    qparams = quantize_multistate_params(m224)
    calib = _from_u8(_u8_requests(scene_pixels(1)).to(dev))
    out["ms224q"] = {"w": qparams,
                     "s": calibrate_multistate_act_scales(qparams, cfg, calib, Rng(0))}
    out["ms224"] = params(m224)
    out["ms448"] = params(MultiStateViTEncoderModel(
        ms448_config(), generator=torch.Generator().manual_seed(0), device=dev).eval())
    out["ss448"] = params(SubsampleViTModel(
        subsample_config(image_size=448, max_depth=3),
        generator=torch.Generator().manual_seed(0), device=dev).eval())
    return out


def _family_inputs() -> dict:
    """Each artifact's requests at `EXPORT_BATCHES`: the first b images of a
    seeded scene (seed 2 at 224, 5 at 448 as `ms448_phase`, 7 for the
    subsample forward), on the host: uint8, f32 for the 448-px multistate
    forwards (`family_forward`)."""
    scenes = {"ms224": _u8_requests(scene_pixels(2)), "ms448": scene_pixels(5, size=448),
              "ss448": _u8_requests(scene_pixels(7, size=448))}
    return {name: {b: scenes[weights.rstrip("q")][:b].contiguous() for b in EXPORT_BATCHES}
            for name, weights, _, _ in EXPORT_FAMILIES}


def _check_family_out(name: str, out: list) -> None:
    """Finite features; cluster ids in [0, num_clusters) (the multistate
    forwards) or a finite log-probability (the subsample one)."""
    ok = bool(torch.isfinite(out[0]).all())
    if name == "ss448":
        ok = ok and bool(torch.isfinite(out[2]).all()) and bool(out[1].any(-1).all())
    else:
        ok = ok and 0 <= int(out[2].min()) and int(out[2].max()) < int(out[1])
    if not ok:
        raise AssertionError(f"the live {name} forward's outputs are malformed")


def _meta(artifact: bytes) -> dict:
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(artifact)) as z:
        return json.loads(z.read("meta.json"))


def _start(script: str, args: list, tmp: str, tag: str, stdin=False):
    env = {**os.environ, "PYTHONPATH": ROOT}
    err = open(os.path.join(tmp, f"{tag}.stderr"), "w")
    proc = subprocess.Popen([sys.executable, "-c", script, tmp, *args], cwd=ROOT, env=env,
                            stdin=subprocess.PIPE if stdin else subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    return proc


def _line(proc, prefix: str, tmp: str, tag: str) -> dict:
    """The JSON after `prefix` on the next line of the child that starts with
    it; the child's stderr in the exception if it ends first."""
    for line in proc.stdout:
        if line.startswith(prefix + " "):
            return json.loads(line[len(prefix) + 1:])
    proc.wait()
    with open(os.path.join(tmp, f"{tag}.stderr")) as fh:
        raise AssertionError(f"{tag} exited ({proc.returncode}) without {prefix}:\n"
                             f"{fh.read()[-4000:]}")


def export_families_phase(dev, smi: str) -> dict:
    """Export -> reload -> serve of the clustered families on the card, each
    forward taking uint8 requests (the 448-px ones f32 pixels) and exported
    with a symbolic batch (`EXPORT_FAMILIES`): the 224-px multistate
    encoder at `bench.py`'s config in bf16 (K5), int8 (K4) and int8 with
    `attn_mode="int8"` (K9); the 448-px one (`ms448_config`) dense (K7) and
    banded (K10); the subsample forward at 448 px, depth 3 (K7 under its
    key-only mask).  (a) One child process per artifact exports it, all at
    once (seconds, bytes, graph nodes); meanwhile this process runs the
    live forwards at batches 1, 2 and 8.  (b) One child per artifact,
    without the model code, reloads it and runs those batches: every
    element equal to the live model's, and its K launched once a layer but
    the last (the subsample forward: once a layer of each of its 4 passes)
    and no other.  (c) In turns, with no other child busy: 5 lone requests
    through the live model and through the artifact (host clock: the
    upload, the forward and the copy back); the bf16 and int8 224-px
    artifacts also served by a
    `BatchingServer` (buckets 1-8: 16 lone requests, each equal to a
    direct call of the artifact, then 4 bursts of 8; valid responses).
    Returns the children's launches of each K."""
    from msvit_tpu_torch.export import load_forward  # noqa: F401  (the op registrations)

    t_phase = time.perf_counter()
    names = [f[0] for f in EXPORT_FAMILIES]
    weights = _family_weights(dev)
    inputs = _family_inputs()
    fns = {name: family_forward(name, dev) for name in names}
    procs = []
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_families_") as tmp:
        try:
            for key, w in weights.items():
                torch.save(w, os.path.join(tmp, f"{key}.params.pt"))
            for name in names:
                torch.save(inputs[name], os.path.join(tmp, f"{name}.inputs.pt"))
            t0 = time.perf_counter()
            exporters = {name: _start(_EXPORT_CHILD, [name, w, str(dev)], tmp, f"export_{name}")
                         for name, w, _, _ in EXPORT_FAMILIES}
            procs += exporters.values()
            # the live forwards, while the children trace
            live = {}
            with torch.inference_mode():
                for name, w, _, _ in EXPORT_FAMILIES:
                    live[name] = {b: [o.cpu() for o in fns[name](weights[w], x.to(dev))]
                                  for b, x in inputs[name].items()}
            for name, w, _, _ in EXPORT_FAMILIES:
                res[name] = {"export": _line(exporters[name], "EXPORTED", tmp, f"export_{name}")}
                exporters[name].wait(timeout=60)
                with open(os.path.join(tmp, f"{name}.msvx"), "rb") as fh:
                    res[name]["nodes"] = _meta(fh.read())["graph_nodes"][dev.type]
            t_export = time.perf_counter() - t0
            log(f"[families] exported with a symbolic batch, one child process each, all at "
                f"once ({t_export:.1f} s wall): " + "; ".join(
                    f"{n} {res[n]['export']['bytes']} bytes in {res[n]['export']['seconds']!r} "
                    f"s, {res[n]['nodes']} graph nodes" for n in names) + f" ({smi})")

            t0 = time.perf_counter()
            loaders = {name: _start(_FAMILY_CHILD, [name, w, str(dev),
                                                    "1" if name in EXPORT_SERVED else "0",
                                                    str(EXPORT_LONE_RUNS)],
                                    tmp, f"reload_{name}", stdin=True)
                       for name, w, _, _ in EXPORT_FAMILIES}
            procs += loaders.values()
            for name in names:
                res[name]["reload"] = _line(loaders[name], "READY", tmp, f"reload_{name}")
            t_reload = time.perf_counter() - t0
            for name, w, k, per in EXPORT_FAMILIES:
                _check_family_out(name, live[name][8])
                outs = torch.load(os.path.join(tmp, f"{name}.outputs.pt"))
                equal = {b: all(torch.equal(a, c) for a, c in zip(outs[b], live[name][b]))
                         for b in EXPORT_BATCHES}
                got = res[name]["reload"]["launches"]
                want = {kk: (per * len(EXPORT_BATCHES) if kk == k else 0) for kk in got}
                res[name]["equal"] = equal
                # num_clusters, or the subsample forward's valid slots
                split = int(live[name][8][1].sum())
                log(f"[families] {name}: reloaded without msvit_tpu_torch.models, batches "
                    f"{list(EXPORT_BATCHES)} equal to the live model on every element {equal}; "
                    f"the child's launches {got} (want {want}); its load and first calls "
                    f"{res[name]['reload']['first_calls_s']!r} s; live num_clusters / valid "
                    f"slots at batch 8: {split} ({smi})")
                if not all(equal.values()):
                    raise AssertionError(f"the reloaded {name} artifact differs from the live model")
                if got != want:
                    raise AssertionError(f"the reloaded {name} artifact launched {got}, want {want}")
            log(f"[families] reload children, all at once: {t_reload:.1f} s wall")

            # (c) in turns: live, then the artifact, lone requests; serving
            x1 = {name: inputs[name][1].to(dev) for name in names}
            for name, w, _, _ in EXPORT_FAMILIES:
                def lone(name=name, w=w):
                    with torch.inference_mode():
                        return [o.cpu() for o in fns[name](weights[w], x1[name])]
                for _ in range(2):
                    lone()
                ms = []
                for _ in range(EXPORT_LONE_RUNS):
                    t0 = time.perf_counter()
                    lone()
                    ms.append((time.perf_counter() - t0) * 1e3)
                loaders[name].stdin.write("go\n")
                loaders[name].stdin.flush()
                done = _line(loaders[name], "DONE", tmp, f"reload_{name}")
                loaders[name].wait(timeout=120)
                res[name].update(lone_live_ms=ms, lone_artifact_ms=done["lone_ms"])
                log(f"[families] {name}: a lone request (bs1, upload + forward + copy back, "
                    f"host clock, {EXPORT_LONE_RUNS} runs after 2) live {ms!r} ms, through "
                    f"the artifact {done['lone_ms']!r} ms: median +"
                    f"{statistics.median(done['lone_ms']) - statistics.median(ms)!r} ms "
                    f"({res[name]['nodes']} nodes run one by one) ({smi})")
                if "served" in done:
                    sv = done["served"]
                    res[name]["served"] = sv
                    st = sv["stats"]
                    log(f"[families] {name} served by a BatchingServer from the artifact "
                        f"({st['requests']} uint8 requests: 16 lone, 4 bursts of 8): "
                        f"{st['requests'] / sv['wall_s']!r} img/s sustained, lone "
                        f"{sv['lone_img_s']!r} img/s; latency p50/p95/p99 {st['p50_ms']!r} / "
                        f"{st['p95_ms']!r} / {st['p99_ms']!r} ms, mean batch "
                        f"{st['mean_batch']!r}; launches while serving {sv['launches']}; lone "
                        f"responses equal to direct calls {sv['lone_equal']}, every response "
                        f"valid {sv['valid']} ({smi})")
                    if (st["requests"] != 48 or not sv["lone_equal"] or not sv["valid"]
                            or not any(sv["launches"].values())):
                        raise AssertionError(f"the served {name} artifact failed its checks")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                for pipe in (p.stdin, p.stdout):
                    if pipe is not None:
                        pipe.close()
    torch.cuda.empty_cache()
    def count(got: dict, k: str):  # K4's, K5's, K7's, K9's and K10's with their routes
        n = got["launches"][k]
        return Launches(n, got["k7_routes"][k]) if k in got["k7_routes"] else n

    launches = {}
    for name, _, k, _ in EXPORT_FAMILIES:
        launches[k] = launches.get(k, 0) + count(res[name]["reload"], k)
        if "served" in res[name]:
            launches[k] += count(res[name]["served"], k)
    log(f"[families] phase 35 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    print("families " + json.dumps({n: {k: v for k, v in r.items() if k != "reload"}
                                    for n, r in res.items()}), flush=True)
    return launches


def _summary(r: dict) -> dict:
    """A timed call's numbers for the kernels line (the kernel alone and the
    share of elements bit-equal to plain too, where its phase took them)."""
    return dict(max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                share_of_bound=r["bound_ms"] / r["ms"],
                **{k: r[k] for k in ("kernel_alone_ms", "library_device_ms", "bit_equal")
                   if k in r})


def ptxas_lines() -> list:
    """Registers and spills of the packed (bf16 K1, K1-lse and K2 on the
    tensor cores, f32 on the CUDA cores), the fused and flash (bf16 K4, K5,
    K7 and K6 on the tensor cores: K4, K5 and K7 are instantiations of one
    mma.sync tile body, K1, K4, K5 and K7 of one wgmma kernel, told apart
    by their source and their tag), the banded (bf16 K10 on the tensor
    cores: banded_wgmma_kernel at dh 64) and the int8 kernels (K3 and K9:
    packed_attention_int8_wgmma_kernel at dh 64, packed_attention_int8_kernel
    at the other head sizes) from ptxas's report; then every line where
    ptxas says that it serialized a kernel's wgmma products."""
    from msvit_tpu_torch.ops import _build

    kernels = (r"attention_wgmma_kernel|"
               r"packed_(?:bwd_dq|bwd_dkv|attention_lse|attention_int8|lse)(?:_w?gmma|_mma)?_kernel|"
               r"packed_mma_kernel|fused_attention_kernel|flash_bwd_(?:dq|dkv)(?:_w?g?mma)?_kernel|"
               r"flash_(?:forward|mma)_kernel|banded(?:_w?g?mma)?_kernel")
    # the bf16 kernels on the tensor cores (templated on the head size only)
    tags = {"packed_mma_kernel": "K1", "packed_lse_mma_kernel": "K1-lse",
            "packed_bwd_dq_mma_kernel": "K2", "packed_bwd_dkv_mma_kernel": "K2",
            "packed_lse_wgmma_kernel": "K1-lse", "packed_bwd_dq_wgmma_kernel": "K2",
            "packed_bwd_dkv_wgmma_kernel": "K2",
            "flash_mma_kernel": "K7/K7-lse",
            "fused_attention_kernel": None, "flash_bwd_dq_kernel": "K6",
            "flash_bwd_dkv_kernel": "K6", "flash_forward_kernel": "K7/K7-lse",
            "flash_bwd_dq_mma_kernel": "K6", "flash_bwd_dkv_mma_kernel": "K6",
            "flash_bwd_dq_wgmma_kernel": "K6", "flash_bwd_dkv_wgmma_kernel": "K6",
            "banded_kernel": "K10", "banded_mma_kernel": "K10", "banded_wgmma_kernel": "K10"}
    out, name, unit, serialized = [], None, None, []
    for line in _build.ptxas_report().read_text().splitlines():
        if line.startswith("$ "):  # the nvcc command of the next source
            unit = re.search(r"(\w+)\.cu$", line).group(1)
            continue
        if "serialized" in line:
            serialized.append(f"{unit}: {line.strip()}")
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
            elif kern.startswith("packed_attention_int8"):  # mma.sync or wgmma
                tag = "K9" if "Lb1E" in name else "K3"
            elif kern == "attention_wgmma_kernel":  # by its source and its tag
                tag = {"packed_attention": "K1", "flash_attention": "K7/K7-lse"}.get(
                    unit, "K4" if "FusedInferenceUnit" in name else "K5/K5-lse")
            else:
                tag = tags.get(kern)
            if tag:
                kern = f"{tag} {kern}"
            # the wgmma kernels are written for head size 64 alone
            dh = "64" if "wgmma" in kern else re.search(r"Li(\d+)E", name).group(1)
            dt = ("int8" if "int8" in kern
                  else "bf16" if "bfloat16" in name or "mma_" in kern else "f32")
            out.append(f"{kern} {dt} dh{dh}: {m.group(1)} registers, {spill}")
    return out + (serialized or ["no wgmma products serialized"])


def main() -> None:
    started = time.perf_counter()
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
    launches, live_served = slice_phase(dev, smi)
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
        torch.cuda.empty_cache()
        b8_to_448_phase(dev, smi, ckpt)
    torch.cuda.empty_cache()
    interp_phase(dev, smi)
    torch.cuda.empty_cache()
    remat_phase(dev, smi)
    torch.cuda.empty_cache()
    mu_dtype_phase(dev, smi)
    torch.cuda.empty_cache()
    clustering_phase(dev, smi)
    torch.cuda.empty_cache()
    predictive_phase(dev, smi)
    torch.cuda.empty_cache()
    # K7's row counts the 448-px multistate forward's launches and the deep
    # subsample forwards' (open and freeze)
    launches["K7"] += sum(subsample_phase(dev, smi).values())
    torch.cuda.empty_cache()
    kernels.update(key_mask_kernel_phase(dev, smi))
    torch.cuda.empty_cache()
    saccadic_phase(dev, smi)
    torch.cuda.empty_cache()
    # K1's and K3's rows add the reloaded artifacts' launches (served and in
    # the reload child) to phase 4's
    for k, n in runtime_phase(dev, smi, live_served).items():
        launches[k] += n
    torch.cuda.empty_cache()
    ex_launches, ex_kernels = extras_phase(dev, smi)
    for k, n in ex_launches.items():
        launches[k] += n
    kernels.update(ex_kernels)
    torch.cuda.empty_cache()
    # the parallel layer's launches: K1 (sequence-sharded trunk, GPipe),
    # K1-lse / K2 (the sharded steps), K7-lse on the K7 row and K6 (ring)
    for k, n in parallel_phase(dev, smi)[0].items():
        launches[k] += n
    torch.cuda.empty_cache()
    # the reloaded artifacts of the clustered families: K4, K5, K7, K9, K10
    for k, n in export_families_phase(dev, smi).items():
        launches[k] += n
    src = "msvit_tpu_torch/csrc/"
    # K4, K5, K5-lse, K6, K7 and K10 at the other shapes their phases timed
    key = "[8,12,1361,64] key-only mask [8,1,1,1361] (subsample 448 px, depth 3)"
    extra = {"K6": [("[8,12,3168,64] soft mask of the 448 partition", "K6@3168"),
                    (key, "K6@key")],
             "K10": [("[8,32+3136,2304] one cluster", "K10@448 one-cluster"),
                     ("[8,32+784,2304] the 224 partition", "K10@224")],
             **{k: [(key, f"{k}@key")] for k in ("K4", "K5", "K5-lse", "K7")},
             "K1": [("[64,197,1920] H 10 after prune_heads", "K1@H10"),
                    ("[8,1370,2304] DINOv2-B/14 518 px", "K1@1370")],
             "K3": [("[64,197,1920] H 10 after prune_heads", "K3@H10")]}
    packed, fused = "msvit_tpu/ops/packed_attention.py:", "msvit_tpu/ops/fused_attention.py:"
    flash = "msvit_tpu/ops/flash_attention.py:"
    row_keys = (
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
    rows = [
        dict(name=name, route="cuda", source=src + cu, replaces=tpu,
             launches=launches[k], **_summary(kernels[k]),
             **({"other_shapes": [dict(shape=tag, **_summary(kernels[key]))
                                  for tag, key in extra[k]]} if k in extra else {}))
        for k, name, cu, tpu in row_keys
    ]
    # the routed kernels' rows split their launches by route: the main
    # path's trunks are at head size 64, so every bf16 and int8 launch took
    # the wgmma route (K1, K5, K5-lse, K6, K7 and K10 also run f32 calls, on
    # the CUDA cores)
    for row in rows:
        k = next(k for k, name, *_ in row_keys if name == row["name"])
        if k not in ("K1", "K1-lse", "K2", "K3", "K4", "K5", "K5-lse", "K6", "K7", "K8a",
                     "K8a-lse", "K8b", "K9", "K10"):
            continue
        routes = getattr(launches[k], "routes", None)
        if routes is None or routes["mma.sync"] or not routes["wgmma"]:
            raise AssertionError(f"{k}: launches {row['launches']}, by route "
                                 f"{routes}: a bf16 or int8 launch off wgmma")
        row["launches_by_route"] = routes
    log(f"[total] chip_smoke.py ran in {time.perf_counter() - started:.1f} s, the kernels' "
        f"build included ({smi})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
