"""Closed-loop batch inference of the multistate encoder.

One client sends a batch of `batch` scene images, takes the encoder's
outputs, and sends the next, back to back, cycling over a pool of
`pool_batches` distinct batches made from the seed; pool batch j always
clusters with the same seed, so its answer is fixed.  The window runs until
`seconds` have passed at the end of a forward, then waits for the device;
the rate is the images of every forward in it over its whole length.

Every batch of the window is compared with the reference of its pool
batch (`compare.multistate`): the last hidden state, the number of
clusters and the last partition, and each clustering event of the pool
batch's latest forward.
"""

from __future__ import annotations

import time

import torch

from perfbench import compare, flops, programs, weights
from perfbench.reference import vit as ref


def clustering_seeds(seed: int, n: int):
    return [weights.stream_seed(seed, 5, j) for j in range(n)]


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    b, size = tr["batch"], cfg["image_size"]
    sd = weights.make(cfg, seed, dev)
    pool = [weights.scenes(b, size, seed, 2, j, device=dev) for j in range(tr["pool_batches"])]
    calib = weights.scenes(b, size, seed, 4, device=dev)
    fn = programs.multistate_forward(cfg, sd, tr["precision"], calib, dev)
    del calib
    seeds = clustering_seeds(seed, len(pool))
    for j, pix in enumerate(pool):  # every shape of the window, once
        fn(pix, seeds[j])
    ctx.sync()

    kept = []
    recorder = programs.ClusteringRecorder()
    with ctx.window():
        t0 = time.perf_counter()
        while True:
            j = len(kept) % len(pool)
            recorder.begin(j)
            out = fn(pool[j], seeds[j])
            kept.append((j, out["last_hidden_state"], out["last_cluster_indices"],
                         out["num_clusters"]))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window = time.perf_counter() - t0
    recorder.close()
    ctx.read_memory_peak()
    del fn, out

    patches = (size // cfg["patch_size"]) ** 2
    c = cfg["clustering"]["max_clusters"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    n = patches + 2 * c
    attn = flops.masked_attention_call(b, n, h, d // h, "bf16", 1, "f32")
    masked_layers = cfg["num_hidden_layers"] - 1  # the last layer runs plain
    counts = {
        "batches": len(kept),
        "images": len(kept) * b,
        "forward_ops": flops.vit_forward_ops(cfg, n, patches),
        "attention_calls": [attn] * (len(kept) * masked_layers),
        "precision": tr["precision"],
    }

    torch.cuda.empty_cache()
    ref.exact_f32()
    with torch.no_grad():
        check = compare.multistate(sd, cfg, pool, seeds, kept, recorder.events)
    return {
        "attempted": len(kept) * b,
        "failed": 0,
        "metrics": {"infer_img_s": len(kept) * b / window},
        "counts": counts,
        "check": check,
    }
