"""Read a cell's comparison numbers for its control, at the cell's size.

    python3 -m perfbench.tools.controls --workload msvit-b8.int8-bs32 --seeds 1 2 3

The control is the plain reference put in the program's place and computed
one precision step below what the configuration states (`control` in
the cell's limits file: int4 for an int8 program, int8 for a bf16 one).
For each seed it makes the cell's weights and inputs as a run does, takes
the control's answers for every pool input, and hands them to the same
comparison a run's answers go through.  One JSON line per seed; the
smallest reading of each number over three seeds or more is the upper
reading its limit is set below.  `--half-batch` reads a training cell's
planted fault instead: the reference's own steps over half of each batch.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json

import torch

from perfbench import compare, spec, weights
from perfbench.loops import train_closed as train
from perfbench.loops.infer_closed import clustering_seeds
from perfbench.reference import train as ref_train
from perfbench.reference import vit as ref
from perfbench.stats import rel_err


def serve_open(cfg, tr, seed, quant, dev) -> dict:
    sd = weights.make(cfg, seed, dev)
    pool = weights.u8_images(tr["pool_images"], cfg["image_size"], seed, 2, device=dev)
    worst = 0.0
    for s in range(0, len(pool), 64):
        pix = pool[s:s + 64].float() / 127.5 - 1.0
        want = ref.vit_forward(sd, cfg, pix)[:, 0]
        got = ref.vit_forward(sd, cfg, pix, quant)[:, 0]
        worst = max(worst, float(rel_err(got, want).max()))
    return {"rel_err_max": worst, "missing": 0.0}


def infer_closed(cfg, tr, seed, quant, dev) -> dict:
    sd = weights.make(cfg, seed, dev)
    pool = [weights.scenes(tr["batch"], cfg["image_size"], seed, 2, j, device=dev)
            for j in range(tr["pool_batches"])]
    seeds = clustering_seeds(seed, len(pool))
    outputs, events = [], {}
    for j, pix in enumerate(pool):
        r = ref.multistate_forward(sd, cfg, pix, seeds[j], quant)
        outputs.append((j, r["last_hidden_state"], r["last_cluster_indices"],
                        r["num_clusters"]))
        events[j] = r["events"]
    return compare.multistate(sd, cfg, pool, seeds, outputs, events)


def train_closed(cfg, tr, seed, quant, dev, rows=None) -> dict:
    """The numbers a run compares, with the control (or the half-batch
    fault) in the program's place: its three steps from the seed, and its
    step at the window's first logged step from the reference's own state
    there."""
    sd = weights.make(cfg, seed, dev, head=True)
    pool = [train.batch(tr["batch"], cfg["image_size"], cfg["num_labels"], seed, j, dev)
            for j in range(tr["pool_batches"])]
    lr, wd, logged = tr["learning_rate"], tr["weight_decay"], tr["log_every"]
    start = pool[:train.FIRST_STEPS]
    start_want = ref_train.three_steps(sd, cfg, start, lr, wd)
    start_got = ref_train.three_steps(sd, cfg, start, lr, wd, quant=quant, rows=rows)
    chain = ref_train.AdamW(sd, lr, wd)
    ref_train.steps(chain, cfg, [pool[s % len(pool)] for s in range(logged - 1)])
    state, last = (chain.m, chain.v, chain.t), [pool[(logged - 1) % len(pool)]]
    window_want = ref_train.steps(ref_train.AdamW(chain.params, lr, wd, state), cfg, last)
    window_got = ref_train.steps(ref_train.AdamW(chain.params, lr, wd, state), cfg, last,
                                 quant=quant, rows=rows)
    window_got["before"] = chain.params
    numbers = train.compare(sd, start_got, start_want, window_got, window_want)
    return dict(numbers, skipped_steps=0.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--half-batch", action="store_true",
                    help="a training cell's planted fault in place of the control: the "
                         "reference's steps over the first half of each batch")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, tr = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    quant = spec.limits(cell["name"])["control"]
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    ref.exact_f32()
    read = {"serve_open": serve_open, "infer_closed": infer_closed,
            "train_closed": train_closed}[tr["loop"]]
    for seed in args.seeds:
        if tr["loop"] == "train_closed":
            half = args.half_batch
            numbers = train_closed(cfg, tr, seed, None if half else quant, dev,
                                   rows=tr["batch"] // 2 if half else None)
        else:
            with torch.no_grad():
                numbers = read(cfg, tr, seed, quant, dev)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": "half-batch" if args.half_batch else quant,
                          **numbers}), flush=True)


if __name__ == "__main__":
    main()
