"""Supervised training in a closed loop: `Trainer.fit` back to back.

Set-up builds one trainer (model and optimizer state) from the seed and
drives it through its first three steps, each through `Trainer.fit` on its
own batch of the pool: they warm up every shape of the window.  The window
hands the same trainer the pool's batches in turn until `seconds` have
passed and the run has made more than `log_every` steps, then waits for
the device; the rate is the images of every step in it over its whole
length.  Step s of the run (1-based) takes pool batch s - 1 mod
`pool_batches`.

Compared with the plain reference:
- the start, from the seed: each of the first three steps' loss, and each
  leaf's norm of the first gradient (from AdamW's first moment after step
  one) and of the parameters' change over the three steps;
- the window, step by step from the program's own state: its last step
  whose loss the trainer reads (every `log_every`-th), taken again by the
  reference from the parameters and moments the program held before it.
  Compared: that loss, each leaf's norm of the step's gradient (from the
  change of the first moment) and of the parameters' change.  Rounding
  grows step by step into a gap that swings from seed to seed, so a window
  step is not held to a reference that followed the run from the seed;
- the steps the optimizer skipped (its count of applied steps against the
  trainer's steps).
The state is copied on the device where the window asks for the batches
around that step (some milliseconds of copies).  The leaves are the
published model's (a fused QKV projection's query, key and value sections
apart).  A leaf's gap is the difference of the two norms over the larger
of the reference's norm of that leaf and of the median leaf; leaves whose
reference gradient is under a thousandth of the median leaf's are left out
(a gradient that is zero to rounding, as a key's bias has under softmax,
moves under Adam by round-off alone).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from perfbench import flops, programs, weights
from perfbench.reference import train as ref_train
from perfbench.reference import vit as ref

FIRST_STEPS = 3


def batch(n: int, size: int, classes: int, seed: int, j: int, dev) -> dict:
    g = weights.generator(seed, 6, j, device=dev)
    return {"pixel_values": torch.randn(n, size, size, 3, generator=g, device=dev),
            "labels": torch.randint(0, classes, (n,), generator=g, device=dev)}


def worst(gaps) -> float:
    """The largest gap; NaN where any is NaN (or there is none)."""
    gaps = list(gaps)
    return math.nan if not gaps or any(math.isnan(x) for x in gaps) else max(gaps)


def leaf_gaps(got: dict, want: dict, keep) -> float:
    """The worst leaf's |norm(got) - norm(want)| over max(norm(want), the
    median leaf's norm), over the leaves in `keep`."""
    if not keep:
        return math.nan
    g = {k: float(got[k].float().norm()) for k in keep}
    w = {k: float(want[k].float().norm()) for k in keep}
    med = statistics.median(w.values())
    return worst(abs(g[k] - w[k]) / max(w[k], med) for k in keep)


def published_leaves(tensors: dict) -> dict:
    """The leaves of the published model: a fused QKV weight or bias is three
    leaves, its query, key and value sections (the key's bias is a leaf whose
    gradient is zero under softmax)."""
    out = {}
    for k, v in tensors.items():
        if k.endswith(("attention.qkv.weight", "attention.qkv.bias")):
            for part, t in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}.{part}"] = t
        else:
            out[k] = v
    return out


def step_gaps(sd, prog: dict, want: dict, before=None) -> dict:
    """prog: the program's loss, gradient and parameters after a step (or
    steps) from `before` (the seed's weights `sd` where None); want: the
    reference's over the same.  The loss's relative gap and the worst
    leaf's gap of the gradient's norm and of the parameters' change."""
    start = sd if before is None else before
    want_grad = published_leaves(want["grad"])
    gnorm = {k: float(v.norm()) for k, v in want_grad.items()}
    finite = [x for x in gnorm.values() if math.isfinite(x)]
    floor = 1e-3 * statistics.median(finite) if finite else math.inf
    keep = [k for k, v in gnorm.items() if v >= floor]

    def change(params):
        return published_leaves({k: params[k].float() - start[k].float() for k in sd})

    return {
        "loss": worst(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(prog["losses"], want["losses"])),
        "grad": leaf_gaps(published_leaves(prog["grad"]), want_grad, keep),
        "update": leaf_gaps(change(prog["params"]), change(want["params"]), keep),
    }


def compare(sd, start: dict, start_want: dict, window: dict, window_want: dict) -> dict:
    """The numbers compared, from the start's and the window step's gaps."""
    a = step_gaps(sd, start, start_want)
    b = step_gaps(sd, window, window_want, before=window["before"])
    return {"loss_gap": a["loss"], "grad_gap": a["grad"], "update_gap": a["update"],
            "window_loss_gap": b["loss"], "window_grad_gap": b["grad"],
            "window_update_gap": b["update"]}


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    n, size, classes = tr["batch"], cfg["image_size"], cfg["num_labels"]
    every = tr["log_every"]
    sd = weights.make(cfg, seed, dev, head=True)
    pool = [batch(n, size, classes, seed, j, dev) for j in range(tr["pool_batches"])]
    trainer = programs.vit_trainer(cfg, sd, tr, dev)
    losses, grad1 = [], None
    for k in range(FIRST_STEPS):
        losses.append(trainer.fit(iter([pool[k]]), k + 1, seed))
        if k == 0:
            m, _ = programs.adam_moments(trainer)
            grad1 = {name: t / (1 - ref_train.B1) for name, t in m.items()}
    params3 = {name: p.detach().clone() for name, p in trainer.model.named_parameters()}
    params = dict(trainer.model.named_parameters())
    m, v = programs.adam_moments(trainer)
    ctx.sync()

    def copy(ts: dict) -> dict:
        return {k: t.detach().clone() for k, t in ts.items()}

    snap = {}

    def feed(t0):
        """The pool's batches in turn; the state around each logged step
        copied where the trainer asks for the batches on either side."""
        s = FIRST_STEPS + 1  # the step the next batch is for (1-based)
        while time.perf_counter() - t0 < ctx.seconds or s <= every + 1:
            if s - 1 == snap.get("step"):
                snap["after"] = (copy(params), copy(m))
            if s % every == 0:
                snap.setdefault("peak", ctx.memory_so_far())
                snap.update(step=s, before=(copy(params), copy(m), copy(v)))
            yield pool[(s - 1) % len(pool)]
            s += 1

    with ctx.window():
        t0 = time.perf_counter()
        window_loss = trainer.fit(feed(t0), 1 << 62, seed)
        ctx.sync()
        window = time.perf_counter() - t0
    ctx.read_memory_peak()
    total = trainer.step
    steps = total - FIRST_STEPS
    skipped = total - programs.applied_steps(trainer)
    logged = snap["step"]
    if logged == total:  # the window ended on it
        snap["after"] = (copy(params), copy(m))
    assert logged == total // every * every, (logged, total)
    (p0, m0, v0), (p1, m1) = snap["before"], snap["after"]

    patches = (size // cfg["patch_size"]) ** 2
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    tokens = patches + 1
    head_ops = 2 * d * classes
    counts = {
        "steps": steps,
        "images": steps * n,
        "forward_ops": flops.vit_forward_ops(cfg, tokens, patches) + head_ops,
        "k1-lse_calls": [flops.packed_attention_lse_call(n, tokens, h, d // h)]
                        * (steps * cfg["num_hidden_layers"]),
        "k2_calls": [flops.packed_attention_bwd_call(n, tokens, h, d // h)]
                    * (steps * cfg["num_hidden_layers"]),
        "window_peak_bytes": snap["peak"],
    }
    del trainer, params, m, v
    torch.cuda.empty_cache()
    ref.exact_f32()
    lr, wd = tr["learning_rate"], tr["weight_decay"]
    start_want = ref_train.three_steps(sd, cfg, pool[:FIRST_STEPS], lr, wd)
    window_want = ref_train.steps(ref_train.AdamW(p0, lr, wd, (m0, v0, logged - 1)), cfg,
                                  [pool[(logged - 1) % len(pool)]])
    start = {"losses": losses, "grad": grad1, "params": params3}
    window_got = {"losses": [window_loss], "params": p1, "before": p0,
                  "grad": {k: (m1[k] - ref_train.B1 * m0[k]) / (1 - ref_train.B1) for k in m1}}
    check = compare(sd, start, start_want, window_got, window_want)
    check["skipped_steps"] = float(skipped)
    return {
        "attempted": steps * n,
        "failed": 0,
        "metrics": {"train_img_s": steps * n / window},
        "counts": counts,
        "check": check,
    }
