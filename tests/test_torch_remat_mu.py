"""PyTorch port, the training leftovers against their references (CPU):
the remat policies "dots" and "dots_no_batch" (selective checkpointing:
the gradients of no remat, and which products the backward recomputes),
and `make_optimizer(mu_dtype=torch.bfloat16)` against
`optax.adamw(mu_dtype=jnp.bfloat16)`, under apply_if_finite and a
schedule, and across a checkpoint."""

import collections
import io

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTForImageClassification as TCls
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import apply_if_finite, make_optimizer

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             image_size=32, patch_size=8)  # 16 patches + CLS

# ----------------------------------------------------------------- remat ----


class _CountOps(TorchDispatchMode):
    """Counts the aten products dispatched while active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.counts[str(func.overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def _backward(impl, remat, policy):
    """Gradients of one loss and the products its backward dispatched."""
    cfg = TCfg(policy=t_parity(), attn_implementation=impl, remat=remat,
               remat_policy=policy, **SMALL)
    model = TCls(cfg, 5, generator=torch.Generator().manual_seed(0))
    pix = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    loss = F.cross_entropy(model(pix), torch.tensor([1, 3]))
    with _CountOps() as ops:
        loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}, ops.counts


@pytest.mark.parametrize("policy", ["", "dots", "dots_no_batch"])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_remat_policy_gradients_equal_no_remat(impl, policy):
    """Every policy on the packed path ("auto": PackedAttentionFunction) and
    the einsum path ("xla"): every gradient within 1e-6 (f32) of no
    remat's."""
    want, _ = _backward(impl, False, "")
    got, _ = _backward(impl, True, policy)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=1e-6, msg=n)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_remat_policies_recompute_no_saved_products(impl):
    """A dispatch count of the backward: "dots" recomputes no product (the
    count of no remat), "dots_no_batch" no `F.linear` GEMM (mm / addmm as
    without remat; the einsum path's batched products, bmm, again), and
    full remat ("") every GEMM of the forward (addmm)."""
    _, none = _backward(impl, False, "")
    _, full = _backward(impl, True, "")
    _, dots = _backward(impl, True, "dots")
    _, nob = _backward(impl, True, "dots_no_batch")
    assert dots == none
    assert nob["mm"] == none["mm"] and nob["addmm"] == none["addmm"]
    assert full["addmm"] > none["addmm"]
    if impl == "xla":  # the attention's einsums: recomputed under dots_no_batch
        assert nob["bmm"] > none["bmm"]


# -------------------------------------------------------------- mu_dtype ----

_SHAPES = {"w": (5, 4), "b": (4,), "e": (3, 2, 2)}


class _Params(nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))


def _grad_stream(seed, n, bad=()):
    """n gradient trees; step i in `bad` holds a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** rng.uniform(-3, 0)
             for k, s in _SHAPES.items()}
        if i in bad:
            g["w"][0, 0] = np.nan
        out.append(g)
    return out


def _run_port(opt, params, grads):
    model = _Params(params)
    state = opt.init(model)
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        finite = torch.tensor(all(np.isfinite(v).all() for v in g.values()))
        state.update(finite)
    return model, state


def _run_optax(opt, params, grads):
    """optax under jit, as the JAX package's train step runs it (eager optax
    rounds b1 * mu to bf16 as well: another answer)."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = opt.init(p)

    @jax.jit
    def step(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    for g in grads:
        p, s = step(p, s, {k: jnp.asarray(v) for k, v in g.items()})
    return p, s


def _adam_state(s):
    """optax's ScaleByAdamState inside (apply_if_finite of) adamw's chain."""
    while not hasattr(s, "mu"):
        s = s.inner_state if hasattr(s, "inner_state") else s[0]
    return s


def _check(model, state, jp, js):
    names = [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), atol=1e-5, rtol=0,
                                   err_msg=n)
    adam = _adam_state(js)
    for n, mu, nu in zip(names, state.mu, state.nu):
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        want = np.asarray(adam.mu[n])
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(mu.view(torch.int16).numpy(), want.view(np.int16),
                                      err_msg=n)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[n]), rtol=1e-6, atol=0)


def _params0():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}


def test_mu_dtype_three_steps_match_optax():
    """Three steps of `make_optimizer(1e-2, weight_decay=1e-2,
    mu_dtype=torch.bfloat16)` against `optax.adamw(..., mu_dtype=
    jnp.bfloat16)` (jitted) on the same gradients: params within 1e-5, mu
    stored in bf16 and bit-equal, nu f32 (1e-6 relative)."""
    params, grads = _params0(), _grad_stream(1, 3)
    model, state = _run_port(make_optimizer(1e-2, weight_decay=1e-2,
                                            mu_dtype=torch.bfloat16), params, grads)
    jp, js = _run_optax(optax.adamw(1e-2, weight_decay=1e-2, mu_dtype=jnp.bfloat16),
                        params, grads)
    assert state.adamw is None
    assert make_optimizer(1e-2).init(model).adamw is not None  # default: fused AdamW
    _check(model, state, jp, js)


def _ramp(step):
    """lr = 0.01 (1 + step): a jnp count, or the port's device count."""
    return 0.01 * (1 + step)


def test_mu_dtype_skip_and_schedule_match_optax():
    """Good, bad (a NaN gradient), good, good under apply_if_finite(3) and
    the schedule lr = 0.01 (1 + applied steps): the bad step leaves params
    and both moments as they were and does not advance the count, as
    `optax.apply_if_finite`; params 1e-5, mu bit-equal."""
    params, grads = _params0(), _grad_stream(2, 4, bad=(1,))
    model, state = _run_port(apply_if_finite(make_optimizer(
        _ramp, weight_decay=1e-2, mu_dtype=torch.bfloat16), 3), params, grads)
    jp, js = _run_optax(optax.apply_if_finite(optax.adamw(
        _ramp, weight_decay=1e-2, mu_dtype=jnp.bfloat16), 3), params, grads)
    assert int(state.count) == 3 and int(state.total_notfinite) == 1
    _check(model, state, jp, js)


def test_mu_dtype_state_round_trips_a_checkpoint():
    """`state_dict` through `torch.save` / `torch.load` into a fresh state:
    mu comes back bf16, and the next step equals the uninterrupted run's
    bit for bit."""
    params, grads = _params0(), _grad_stream(3, 3)
    opt = make_optimizer(1e-2, weight_decay=1e-2, mu_dtype=torch.bfloat16)
    ref, ref_state = _run_port(opt, params, grads)
    model, state = _run_port(opt, params, grads[:2])
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "opt": state.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf)
    fresh = _Params(params)
    fresh.load_state_dict(saved["model"])
    fresh_state = opt.init(fresh)
    fresh_state.load_state_dict(saved["opt"])
    assert all(m.dtype == torch.bfloat16 for m in fresh_state.mu)
    assert int(fresh_state.count) == 2
    for k, p in fresh.named_parameters():
        p.grad = torch.from_numpy(grads[2][k].copy())
    fresh_state.update(None)
    for (n, a), (_, b) in zip(fresh.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(fresh_state.mu + fresh_state.nu, ref_state.mu + ref_state.nu):
        assert torch.equal(a, b)
