"""A dry run of the parallel layer on n CPU ranks (counterpart of
`__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n)` starts n gloo ranks (`launch.RankPool`) and runs on
each, at a tiny config: a dp x tp train step (tp = 2 where n is even) with
ZeRO-1, sequence sharding and experts sharded on "model"; an FSDP step;
ring attention against dense attention.  It raises if any of them fails
or gives a non-finite loss, and returns each rank's losses.

    python -m msvit_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch
import torch.nn.functional as F


def dryrun_rank(rank: int, world: int):
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTForImageClassification
    from msvit_tpu_torch.parallel.mesh import make_mesh
    from msvit_tpu_torch.parallel.ring_attention import ring_attention
    from msvit_tpu_torch.parallel.train_step import make_sharded_train_step
    from msvit_tpu_torch.train import Optimizer

    tp = 2 if world % 2 == 0 and world > 1 else 1
    cfg = BaseViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        image_size=32, patch_size=16, sequence_sharding=tp > 1,
                        num_experts=2 * tp if tp > 1 else 0)
    gen = torch.Generator().manual_seed(0)
    pixels = torch.randn((2 * world, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (2 * world,), generator=gen)

    def loss_fn(model, batch, g):
        return F.cross_entropy(model(batch[0]), batch[1]), {}

    losses = {}
    for name, tp_, kw in (("dp_tp_zero1_seq", tp, {"zero1": True}),
                          ("fsdp", 1, {"fsdp": True})):
        mesh = make_mesh(tp=tp_, device_type="cpu")
        model = ViTForImageClassification(cfg if name != "fsdp" else BaseViTConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
            patch_size=16), 10)
        step, opt_state = make_sharded_train_step(loss_fn, Optimizer(learning_rate=1e-3),
                                                  mesh, model, **kw)
        dp, d = mesh["data"].size(), mesh.get_local_rank("data")
        b = pixels.shape[0] // dp
        batch = (pixels[d * b:(d + 1) * b], labels[d * b:(d + 1) * b])
        losses[name] = [float(step(model, opt_state, batch, torch.Generator().manual_seed(i))[0])
                        for i in range(2)]
    mesh = make_mesh(tp=world, device_type="cpu")
    q, k, v = torch.randn((3, 2, 4 * world, 2, 8), generator=gen).unbind()
    out = ring_attention(q, k, v, mesh, batch_axis=None)
    dense = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5, -1)
    losses["ring_dev"] = float((out - torch.einsum("bhqk,bkhd->bqhd", dense, v)).abs().max())
    bad = [k for k, v in losses.items() if k != "ring_dev" and not all(
        torch.isfinite(torch.tensor(v)))]
    if bad or losses["ring_dev"] > 1e-5:
        raise RuntimeError(f"dry run failed on rank {rank}: {losses}")
    return losses


def dryrun_multichip(n: int, pool=None) -> List[dict]:
    """Run `dryrun_rank` on n CPU ranks (a new `RankPool`, or `pool`)."""
    from msvit_tpu_torch.parallel.launch import RankPool

    if pool is not None:
        return pool.run("msvit_tpu_torch.parallel.dryrun:dryrun_rank")
    with RankPool(n) as own:
        return own.run("msvit_tpu_torch.parallel.dryrun:dryrun_rank")


def main(argv: Optional[List[str]] = None) -> None:
    n = int((argv or sys.argv[1:] or ["4"])[0])
    for rank, out in enumerate(dryrun_multichip(n)):
        print(rank, out)


if __name__ == "__main__":
    main()
