"""Rank bodies of the port's parallel-layer tests (`tests/test_torch_parallel.py`,
`tests/test_torch_ring_attention.py`, `tests/test_torch_pipeline.py`).

Each function runs on every rank of a `msvit_tpu_torch.parallel.launch.
RankPool` (gloo, CPU) and returns numpy arrays.  This module imports no JAX:
the ranks never load it; the JAX references run in the pytest process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from msvit_tpu_torch.models.base import BaseViTConfig
from msvit_tpu_torch.models.base.model import BaseViTEncoder
from msvit_tpu_torch.models.base.vit import ViTForImageClassification, ViTModel
from msvit_tpu_torch.parallel import distributed as pdist
from msvit_tpu_torch.parallel.mesh import make_mesh
from msvit_tpu_torch.parallel.sharding import (
    full_state_dict, parallelize, shard_params, sum_partial_grads)
from msvit_tpu_torch.parallel.train_step import make_sharded_train_step
from msvit_tpu_torch.settings import parity_policy
from msvit_tpu_torch.train import Optimizer


def _np(t):
    return t.detach().float().numpy().copy()


def _state(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def _cfg(cfg):
    return BaseViTConfig(policy=parity_policy(), **cfg)


def _classifier(cfg, state, num_labels=10):
    model = ViTForImageClassification(_cfg(cfg), num_labels)
    model.load_state_dict(_state(state))
    return model


def no_jax(rank, world):
    return "jax" in sys.modules


def helpers(rank, world):
    """The multi-process glue on 4 ranks at dp=4 (tp=1)."""
    pdist.initialize()  # a group exists: a no-op
    mesh = make_mesh(tp=1, device_type="cpu")
    local = {"x": torch.arange(8.0).reshape(4, 2) + 100 * rank, "y": (torch.ones(4) * rank,)}
    g = pdist.global_batch(mesh, local)
    return {"shard": pdist.host_shard(), "per_rank": pdist.host_batch_size(32),
            "global_shape": tuple(g["x"].shape), "local": _np(g["x"].to_local()),
            "y_shape": tuple(g["y"][0].shape)}


def forward(rank, world, cfg, state, pixels, tp, mask=None, num_labels=10, train=False,
            seed=0):
    """The classifier's logits (or, with `num_labels` None, the ViTModel's
    last hidden state) under `parallelize` at `tp`, beside the unsharded
    model's, on the same weights and pixels.  `train`: dropout on, the
    masks from `seed`; then also the gradients of sum(out * r), r fixed
    and random, whose deviation is returned relative to each tensor's
    largest gradient."""
    mesh = make_mesh(tp=tp, device_type="cpu")
    if num_labels is None:
        model = ViTModel(_cfg(cfg))
        model.load_state_dict(_state(state))
    else:
        model = _classifier(cfg, state, num_labels)
    ref = ViTModel(_cfg(cfg)) if num_labels is None else ViTForImageClassification(
        _cfg(cfg), num_labels)
    ref.load_state_dict(model.state_dict())
    parallelize(model, mesh)
    x = torch.from_numpy(pixels)
    m = None if mask is None else torch.from_numpy(mask)
    outs = []
    for net in (model, ref):
        net.train(train)
        gen = torch.Generator().manual_seed(seed)
        if num_labels is None:
            out = net(x, attention_mask=m, generator=gen)["last_hidden_state"]
        else:
            out = net(x, generator=gen)
        grads = {}
        if train:  # a fixed random direction (sum(LN(h)^2) is ~constant)
            r = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
            (out.float() * r).sum().backward()
            if net is model:
                sum_partial_grads(model)
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        outs.append((out, grads))
    (got, g_got), (want, g_want) = outs
    if train:  # the sharded model's gradients, gathered
        g_got = full_state_dict(model, grads=True)
    return {"got": _np(got), "want": _np(want),
            "grad_dev": max((float((g_got[n] - g_want[n]).abs().max()
                                   / g_want[n].abs().max().clamp_min(1e-30)) for n in g_want),
                            default=0.0)}


def train(rank, world, cfg, state, pixels, labels, tp, steps=2, lr=1e-2, zero1=False,
          fsdp=False, clip=None, mu_dtype=None):
    """`steps` AdamW steps of the sharded step (a bf16 first moment with
    `mu_dtype="bfloat16"`); each rank feeds its data index's part of the
    batch.  Returns the losses, the gradients after the first step and the
    parameters after the last (whole), and the elements of AdamW's moments
    this rank keeps (and the first moment's dtype), and the parameters
    after the first step."""
    mesh = make_mesh(tp=tp, device_type="cpu")
    model = _classifier(cfg, state)
    opt = Optimizer(learning_rate=lr, weight_decay=1e-4, clip_norm=clip,
                    mu_dtype=None if mu_dtype is None else getattr(torch, mu_dtype))

    def loss_fn(m, batch, gen):
        return F.cross_entropy(m(batch[0]), batch[1]), {}

    step, opt_state = make_sharded_train_step(loss_fn, opt, mesh, model, zero1=zero1,
                                              fsdp=fsdp)
    dp, d = mesh["data"].size(), mesh.get_local_rank("data")
    b = pixels.shape[0] // dp
    batch = (torch.from_numpy(pixels[d * b:(d + 1) * b]),
             torch.from_numpy(labels[d * b:(d + 1) * b]).long())
    losses, grads, params1 = [], None, None
    for i in range(steps):
        loss, _ = step(model, opt_state, batch, torch.Generator().manual_seed(i))
        losses.append(float(loss))
        if grads is None:
            params1 = {k: _np(v) for k, v in full_state_dict(model).items()}
            grads = {k: _np(v) for k, v in full_state_dict(model, grads=True).items()}
    inner = getattr(opt_state, "inner", opt_state)
    if inner.adamw is None:  # the port's own update: local moments
        moments = sum(m.numel() for m in (*inner.mu, *inner.nu))
        mu = str(inner.mu[0].dtype)
    else:
        moments = sum(_local(v).numel() for st in inner.adamw.state.values()
                      for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
        mu = str(_local(next(iter(inner.adamw.state.values()))["exp_avg"]).dtype)
    qkv = dict(model.named_parameters())["vit.encoder.layer.0.attention.qkv.weight"]
    return {"losses": losses, "grads": grads, "moments": moments, "params1": params1,
            "mu_dtype": mu,
            "params": {k: _np(v) for k, v in full_state_dict(model).items()},
            "qkv_local": int(_local(qkv).numel()), "qkv_dtensor": hasattr(qkv, "to_local")}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def checkpoint_tp(rank, world, cfg, state, directory):
    """Save a tp=2 model's state with torch.distributed.checkpoint, restore
    it into zeroed tensors of the same layout and into a tp=4 layout."""
    from msvit_tpu_torch.parallel.sharding import load_sharded_state_dict, sharded_state_dict
    from msvit_tpu_torch.train import restore_sharded_checkpoint, save_sharded_checkpoint

    mesh = make_mesh(tp=2, device_type="cpu")
    model = ViTModel(_cfg(cfg))
    model.load_state_dict(_state(state))
    parallelize(model, mesh)
    save_sharded_checkpoint(directory, 1, sharded_state_dict(model))
    want = full_state_dict(model)
    out = {}
    for tp in (2, 4):
        other = ViTModel(_cfg(cfg))
        for p in other.parameters():
            p.data.zero_()
        parallelize(other, make_mesh(tp=tp, device_type="cpu"))
        like = sharded_state_dict(other)
        restore_sharded_checkpoint(directory, like)
        load_sharded_state_dict(other, like)
        got = full_state_dict(other)
        out[tp] = max(float((got[k] - want[k]).abs().max()) for k in want)
    return out


def checkpoint_fsdp(rank, world, cfg, state, pixels, directory):
    """Parameters sharded by FSDP over 4 data ranks, saved, restored onto
    plain replicated (data-parallel) tensors."""
    from msvit_tpu_torch.train import restore_sharded_checkpoint, save_sharded_checkpoint

    mesh = make_mesh(tp=1, device_type="cpu")
    model = ViTModel(_cfg(cfg))
    model.load_state_dict(_state(state))

    def loss_fn(m, batch, gen):
        return (m(batch)["last_hidden_state"].float() ** 2).sum(), {}

    step, opt_state = make_sharded_train_step(loss_fn, Optimizer(learning_rate=1e-3), mesh,
                                              model, fsdp=True)
    step(model, opt_state, torch.from_numpy(pixels), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    sharded = [k for k, v in sd.items() if hasattr(v, "placements")
               and v.to_local().numel() < v.numel()]
    save_sharded_checkpoint(directory, 3, sd)
    plain = ViTModel(_cfg(cfg))
    like = {k: torch.zeros_like(v) for k, v in plain.state_dict().items()}
    restore_sharded_checkpoint(directory, like)
    want = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v) for k, v in sd.items()}
    return {"sharded": len(sharded),
            "dev": max(float((like[k] - want[k]).abs().max()) for k in want),
            "plain": all(type(v) is torch.Tensor for v in like.values())}


def moe_encoder(rank, world, cfg, state, x):
    """The MoE encoder with experts sharded 4-way on "model" against the
    replicated one."""
    mesh = make_mesh(tp=4, device_type="cpu")
    enc = BaseViTEncoder(_cfg(cfg), torch.Generator().manual_seed(0))
    enc.load_state_dict(_state(state))
    ref = BaseViTEncoder(_cfg(cfg), torch.Generator().manual_seed(0))
    ref.load_state_dict(enc.state_dict())
    parallelize(enc, mesh)
    xs = torch.from_numpy(x)
    with torch.no_grad():
        got, want = enc.eval()(xs)[0], ref.eval()(xs)[0]
    return {"got": _np(got), "want": _np(want),
            "experts_local": tuple(enc.layer[0].mlp.experts_in.shape)}


def ring(rank, world, q, k, v, g, mask=None, dtype="float32"):
    """`ring_attention` over 4 "model" ranks: output and the gradients of
    sum(out * g)."""
    from msvit_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh(tp=4, device_type="cpu")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    out = ring_attention(q, k, v, mesh, key_padding_mask=m)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}


def ring_indivisible(rank, world):
    from msvit_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh(tp=4, device_type="cpu")
    q = torch.zeros(1, 10, 2, 8)
    try:
        ring_attention(q, q, q, mesh)
    except ValueError as e:
        return str(e)
    return ""


def gpipe_encoder(rank, world, cfg, state, x, grads=False):
    """The encoder's 8 layers as 4 stages of 2, 4 microbatches of 2."""
    from torch import nn

    from msvit_tpu_torch.models.base.model import BaseViTLayer
    from msvit_tpu_torch.parallel.pipeline import (
        gpipe, make_layer_stage_fn, make_stage_mesh, split_layers_into_stages)

    mesh = make_stage_mesh(4, device_type="cpu")
    c = _cfg(cfg)
    layers = nn.ModuleList(BaseViTLayer(c, torch.Generator().manual_seed(0)) for _ in range(2))
    layers.load_state_dict(split_layers_into_stages(_state(state), 4)[rank])
    run = gpipe(make_layer_stage_fn(layers), 4, 4, mesh)
    xs = torch.from_numpy(x).reshape(4, 2, *x.shape[1:])
    out = run(xs).reshape(x.shape)
    res = {"out": _np(out)}
    if grads:
        (out ** 2).sum().backward()
        res["grads"] = {f"layer.{2 * rank + int(n.split('.')[0])}.{n.split('.', 1)[1]}":
                        _np(p.grad) for n, p in layers.named_parameters()}
    return res


def pipelined_classifier(rank, world, cfg, state, pixels, mask=None, labels=None, lr=1e-3):
    """The pipelined classifier on 4 stages: logits (masked or not), and
    with `labels` one `Trainer` AdamW step; returns its stage's state."""
    from msvit_tpu_torch.parallel.pipeline import make_stage_mesh
    from msvit_tpu_torch.parallel.pipeline_vit import (
        PipelinedViTClassifier, make_pipelined_classifier_apply, make_pipelined_loss_fn,
        shard_pipeline_params)
    from msvit_tpu_torch.train import Trainer, make_optimizer

    mesh = make_stage_mesh(4, device_type="cpu")
    c = _cfg(cfg)
    model = PipelinedViTClassifier(c, 10, 4)
    model.load_state_dict(shard_pipeline_params(mesh, _state(state), 4))
    x = torch.from_numpy(pixels)
    if labels is None:
        apply = make_pipelined_classifier_apply(c, 10, 4, 4, mesh)
        with torch.no_grad():
            logits = apply(model, x, None if mask is None else torch.from_numpy(mask))
        return {"logits": _np(logits)}
    loss_fn = make_pipelined_loss_fn(c, 10, 4, 4, mesh)
    trainer = Trainer(loss_fn, make_optimizer(lr, weight_decay=1e-4), model, log_every=1)
    loss = trainer.fit([{"pixel_values": x, "labels": torch.from_numpy(labels).long()}],
                       num_steps=1, seed=0)
    return {"loss": loss, "state": {k: _np(v) for k, v in model.state_dict().items()}}


def dryrun(rank, world):
    from msvit_tpu_torch.parallel.dryrun import dryrun_rank

    return dryrun_rank(rank, world)


def shard_layouts(rank, world, cfg, state):
    """`shard_params` of a full state dict equals the shards `parallelize`
    cut from the model (tp=2)."""
    mesh = make_mesh(tp=2, device_type="cpu")
    model = _classifier(cfg, state)
    parallelize(model, mesh)
    local = shard_params(mesh, _state(state), _cfg(cfg))
    live = model.state_dict()
    return all(torch.equal(live[k], local[k]) for k in live)


def multistate_dp(rank, world, pixels):
    """The multistate encoder (clustering included) data-parallel over 4
    ranks: each rank's shard of a global batch against the unsharded model
    on that shard with the same clustering seed."""
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig, MultiStateViTEncoderModel

    cfg = MultiStateViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
        patch_size=8, pregeneration_period=1, generation_period=1, policy=parity_policy(),
        attn_implementation="xla",
        clustering=SpectralClusteringConfig(ncut_dim=4, num_sample=16, max_clusters=4,
                                            eigenvalue_threshold=0.1))
    mesh = make_mesh(tp=1, device_type="cpu")
    model = MultiStateViTEncoderModel(cfg).eval()
    ref = MultiStateViTEncoderModel(cfg).eval()
    parallelize(model, mesh)
    b = pixels.shape[0] // world
    batch = pdist.global_batch(mesh, torch.from_numpy(pixels[rank * b:(rank + 1) * b]))
    with torch.no_grad():
        got = model(batch.to_local(), rng=7)["last_hidden_state"]
        want = ref(batch.to_local(), rng=7)["last_hidden_state"]
    return {"dev": float((got - want).abs().max()), "global": tuple(batch.shape)}


def vit_b16_tp(rank, world):
    """ViT-B/16 at full width (12 heads of 64) under tp=4, bs2 at 224 px, its
    f32 forward against the unsharded model's (weights from seed 0)."""
    import copy

    cfg = BaseViTConfig(policy=parity_policy())
    model = ViTModel(cfg)
    ref = copy.deepcopy(model)
    parallelize(model, make_mesh(tp=4, device_type="cpu"))
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.eval()(x)["last_hidden_state"]
        want = ref.eval()(x)["last_hidden_state"]
    return {"shape": tuple(got.shape), "finite": bool(torch.isfinite(got).all()),
            "dev": float((got - want).abs().max()),
            "heads": model.encoder.layer[0].attention.num_heads}
