"""Open-loop serving of one image per request through `BatchingServer`.

Requests arrive on a schedule fixed by the seed: `rate` x the window's
seconds arrival times, uniform over the window and sorted (Poisson arrivals
with the count fixed, so every seed offers the same work), each carrying an
image drawn from a seeded pool.  A generator thread submits each request at
its due time; each request's latency runs from that due time to the moment
its response reached the host (the future's completion), so a stall delays
every request behind it.  After the window the run waits up to `drain_s`
for the responses still out; one that fails or never comes counts as slower
than every other.

Every response is compared with the reference forward of its own image.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from perfbench import flops, programs, weights
from perfbench.reference import vit as ref
from perfbench.stats import percentile, rel_err


def schedule(rate: float, seconds: float, pool: int, seed: int):
    """(due times [n] in seconds from the window's start, pool index [n])."""
    n = int(round(rate * seconds))
    rng = np.random.default_rng(weights.stream_seed(seed, 3))
    return np.sort(rng.uniform(0.0, seconds, n)), rng.integers(0, pool, n)


class Requests:
    """Due times, submission and completion times and answers of one
    window's requests.  A request's future is dropped once it has answered
    (its answer copied into `answers`), as a server's client would, so the
    heap does not grow with the window."""

    def __init__(self, due: np.ndarray, idx: np.ndarray, width: int):
        self.due, self.idx = due, idx
        n = len(due)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.answers = np.full((n, width), np.nan, dtype=np.float32)
        self._lock = threading.Lock()
        self._open = n
        self.all_done = threading.Event()

    def drive(self, server, images: np.ndarray, t0: float) -> None:
        """Submit request i at t0 + due[i] (the generator thread's body)."""
        for i, due in enumerate(self.due):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.sent[i] = time.perf_counter() - t0
            server.submit(images[self.idx[i]]).add_done_callback(self._on_done(i, t0))

    def _on_done(self, i: int, t0: float):
        def cb(fut):
            if fut.exception() is None:
                self.done[i] = time.perf_counter() - t0
                self.answers[i] = fut.result().numpy()
            with self._lock:
                self._open -= 1
                if not self._open:
                    self.all_done.set()
        return cb


class Served:
    """The program as the cell serves it: a warmed `BatchingServer` in front
    of the int8 forward (buckets of at most `small_bucket_max` to the bf16
    one), and the pool of request images."""

    def __init__(self, cfg, tr, seed: int, dev):
        from msvit_tpu_torch.serve import BatchingServer

        size = cfg["image_size"]
        self.width = cfg["hidden_size"]
        self.weights = weights.make(cfg, seed, dev)
        self.pool_dev = weights.u8_images(tr["pool_images"], size, seed, 2, device=dev)
        calib = weights.u8_images(tr["calibration_images"], size, seed, 4, device=dev)
        int8_fn, bf16_fn = programs.vit_serving(cfg, self.weights, calib.cpu().numpy(), dev)
        self.pool = self.pool_dev.cpu().numpy()
        self.buckets = []  # the batch each int8 call ran, padding rows included

        def int8_call(u8):
            self.buckets.append(len(u8))
            return int8_fn(u8)

        self.server = BatchingServer(int8_call, self.pool[0], max_batch=tr["max_batch"],
                                     max_wait_ms=tr["max_wait_ms"], small_apply_fn=bf16_fn,
                                     small_bucket_max=tr["small_bucket_max"])
        for _ in range(2):
            self.server.warmup()

    def offer(self, due: np.ndarray, idx: np.ndarray, seconds: float, drain_s: float):
        """Submit each request at its due time from a generator thread, then
        wait up to `drain_s` past the window for the answers still out.
        Returns (requests, completion times as they stood when the run gave
        up waiting, that moment), all in seconds from the window's start."""
        reqs = Requests(due, idx, self.width)
        t0 = time.perf_counter()
        gen = threading.Thread(target=reqs.drive, args=(self.server, self.pool, t0))
        gen.start()
        gen.join()
        reqs.all_done.wait(timeout=max(0.0, t0 + seconds + drain_s - time.perf_counter()))
        gave_up = time.perf_counter() - t0
        return reqs, reqs.done.copy(), gave_up


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    size = cfg["image_size"]
    served = Served(cfg, tr, seed, dev)
    server, pool, pool_dev, sd = served.server, served.pool, served.pool_dev, served.weights
    ctx.sync()
    buckets = served.buckets
    buckets.clear()

    due, idx = schedule(tr["rate"], ctx.seconds, len(pool), seed)
    with ctx.window():
        reqs, done, gave_up = served.offer(due, idx, ctx.seconds, tr["drain_s"])
    stats = server.stats()
    server.close()
    ctx.read_memory_peak()

    # a request without an answer counts as answered when the run gave up
    # waiting: later than any answer
    lat = np.where(np.isnan(done), gave_up, done) - due
    answered = ~np.isnan(done)
    late = reqs.sent - reqs.due
    ctx.log(f"generator lateness: median {percentile(late, 50) * 1e3!r} ms, p99 "
            f"{percentile(late, 99) * 1e3!r} ms, max {float(np.nanmax(late)) * 1e3!r} ms "
            f"over {len(late)} requests")
    patches = (size // cfg["patch_size"]) ** 2
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    counts = {
        "latency_s": lat,
        "mean_batch": stats["mean_batch"],
        "images": int(answered.sum()),
        "forward_ops": flops.vit_forward_ops(cfg, patches + 1, patches),
        "k3_calls": [flops.packed_attention_call(b, patches + 1, h, d // h, "int8", "int8")
                     for b in buckets for _ in range(cfg["num_hidden_layers"])],
    }

    # the reference, once the program is gone: every answer against the
    # reference forward of its own image
    del served, server
    torch.cuda.empty_cache()
    ref.exact_f32()
    check = {"missing": float((~answered).sum())}
    if answered.any():
        used = np.unique(idx)
        want = torch.empty((len(pool), d), device=dev)
        with torch.no_grad():
            for s in range(0, len(used), 64):
                rows = torch.from_numpy(used[s:s + 64]).to(dev)
                pix = pool_dev[rows].float() / 127.5 - 1.0
                want[rows] = ref.vit_forward(sd, cfg, pix)[:, 0]
        got = torch.from_numpy(reqs.answers[answered]).to(dev)
        rows = torch.from_numpy(idx[answered]).to(dev)
        check["rel_err_max"] = float(rel_err(got, want[rows]).max())
    else:
        check["rel_err_max"] = math.inf
    return {
        "attempted": len(due),
        "failed": int((~answered).sum()),
        "metrics": {"serve_p95_ms": percentile(lat, 95) * 1e3},
        "counts": counts,
        "check": check,
    }
