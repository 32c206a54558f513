"""Train-step scaffolding (counterpart of `msvit_tpu/train/loop.py`).

JAX's step is a pure function, (params, opt_state, batch, rng) -> new
ones.  Here the model and the optimizer state are objects that a step
updates in place: ``step(model, opt_state, batch, generator[, ema]) ->
(loss, aux)``, with `loss_fn(model, batch, generator) -> (loss, aux)`.

The optimizer is `torch.optim.AdamW` (fused), configured as `optax.adamw`:
b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay.  `make_optimizer`
returns a recipe; ``recipe.init(model)`` builds its state, as an optax
`GradientTransformation.init` does.  With ``mu_dtype`` (a bf16 first
moment, `optax.adamw(mu_dtype=...)`) the update is the port's own, in
`torch._foreach_*` ops, step for step as optax computes it under jit (the
JAX package's train step): both moments updated in f32 (b1 rounded to the
stored mu's dtype, as optax's Python float is where it meets a bf16 array:
0.8984375 for bf16), the bias-corrected update from that f32 mu, and only
then mu rounded to `mu_dtype` for storage; nu stays in the parameter's
dtype.  That update runs on each parameter's local tensor (`local_tensor`):
under FSDP the parameters and gradients are `DTensor` shards, and each
rank updates its own shard, with moments of the shard's size.

Non-finite steps (`apply_if_finite`, optax semantics): a step whose
gradients hold a NaN or an Inf leaves the params, both moments and the
step count untouched, unless more than `max_nonfinite` consecutive steps
were bad, in which case it is applied.  The decision stays on the device:
the flag is handed to the fused AdamW as its `found_inf` tensor (the
protocol `torch.amp.GradScaler` uses), so no step waits on the host.
Gradient clipping (`Optimizer.clip_norm`, the counterpart of
``optax.chain(optax.clip_by_global_norm(c), optax.adamw(...))``): before
the update every gradient is multiplied by ``c / max(norm, c)``, norm the
global L2 norm of the unclipped gradients, formed on the device from the
per-tensor norms (no host sync).  Under `apply_if_finite` the finiteness is
judged on the unclipped gradients, as optax judges the chain's input.

A learning-rate schedule is read at the count of applied steps, a device
tensor that a skipped step leaves alone, as optax's inner count: the
schedule takes that 0-d int32 tensor and returns a 0-d f32 tensor, which
the fused AdamW takes as its lr (no host sync).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from msvit_tpu_torch.utils.profiling import span
from msvit_tpu_torch.utils.rng import draw_seed

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]
LossFn = Callable[[nn.Module, Any, torch.Generator], Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An AdamW recipe, the counterpart of an optax transformation.

    learning_rate: a float or a `step -> lr` schedule: step a 0-d int32
      tensor counting the applied steps from 0, lr a 0-d tensor on its
      device (torch ops only: a host read would sync every step).
    trainable: `name_tuple -> bool` over the model's parameter names split
      at "."; the others get no update and no decay (optax `set_to_zero`).
    max_nonfinite: set by `apply_if_finite`.
    clip_norm: global-norm clip of the gradients ahead of AdamW
      (`optax.clip_by_global_norm`); None or 0 disables it.
    mu_dtype: the first moment's storage dtype (None: the fused AdamW,
      moments in the parameter's dtype)."""

    learning_rate: Schedule = 1e-3
    weight_decay: float = 1e-2
    trainable: Optional[Callable[[Tuple[str, ...]], bool]] = None
    max_nonfinite: Optional[int] = None
    clip_norm: Optional[float] = None
    mu_dtype: Optional[torch.dtype] = None

    def init(self, model: nn.Module) -> "OptState":
        return OptState(self, model)


def make_optimizer(
    learning_rate: Schedule = 1e-3,
    weight_decay: float = 1e-2,
    trainable: Optional[Callable[[Tuple[str, ...]], bool]] = None,
    mu_dtype=None,
    clip_norm: Optional[float] = None,
) -> Optimizer:
    """AdamW, optionally masked to a trainable subset by parameter name,
    optionally behind a global-norm clip of the gradients.
    ``mu_dtype=torch.bfloat16`` stores the first moment in bf16 (the second
    stays in the parameter's dtype: its EMA of tiny squared gradients would
    underflow bf16's 8-bit mantissa)."""
    return Optimizer(learning_rate, weight_decay, trainable,
                     clip_norm=clip_norm or None, mu_dtype=mu_dtype)


def apply_if_finite(optimizer: Optimizer, max_nonfinite: int) -> Optimizer:
    """`optax.apply_if_finite(optimizer, max_nonfinite)`."""
    return dataclasses.replace(optimizer, max_nonfinite=max_nonfinite)


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A `DTensor`'s local shard (under no_grad, the tensor that holds its
    data), any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


class OptState:
    """An `Optimizer`'s state for one model: a fused `torch.optim.AdamW`
    over the trainable parameters (with `mu_dtype`, the moments `mu` and
    `nu` of the port's own update), the count of applied steps (the
    schedule's argument, and Adam's bias-correction count), and
    apply_if_finite's counters (device tensors)."""

    def __init__(self, spec: Optimizer,
                 model: Union[nn.Module, Iterable[Tuple[str, nn.Parameter]]]):
        """`model`: a module, or (name, parameter) pairs (the ZeRO-1 step
        hands its shards of the parameters)."""
        self.spec = spec
        pairs = model.named_parameters() if isinstance(model, nn.Module) else model
        named = [
            (n, p) for n, p in pairs
            if p.requires_grad
            and (spec.trainable is None or spec.trainable(tuple(n.split("."))))
        ]
        if not named:
            raise ValueError("no trainable parameters")
        self.params = [p for _, p in named]
        lr = spec.learning_rate
        self.adamw = None
        if spec.mu_dtype is None:
            self.adamw = torch.optim.AdamW(
                self.params, lr=0.0 if callable(lr) else float(lr),
                betas=(_B1, _B2), eps=_EPS, weight_decay=spec.weight_decay,
                fused=True,
            )
        else:
            local = [local_tensor(p.detach()) for p in self.params]
            self.mu = [torch.zeros_like(p, dtype=spec.mu_dtype) for p in local]
            self.nu = [torch.zeros_like(p) for p in local]
        dev = named[0][1].device
        # applied steps, the schedule's argument (optax's inner count)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)

    def update(self, grads_finite: Optional[torch.Tensor]) -> None:
        """One AdamW step from the parameters' `.grad`.  Under
        apply_if_finite `grads_finite` (a device bool) decides, on the
        device, whether the step is taken; the count of applied steps
        advances with it."""
        lr = self.spec.learning_rate
        lr_now = lr(self.count) if callable(lr) else lr
        skip = None
        if self.spec.max_nonfinite is not None:
            bad = ~grads_finite
            self.notfinite_count = torch.where(
                bad, self.notfinite_count + 1, torch.zeros_like(self.notfinite_count))
            self.total_notfinite = self.total_notfinite + bad.int()
            skip = bad & (self.notfinite_count <= self.spec.max_nonfinite)
        if self.adamw is None:
            self._update_mu_dtype(lr_now, skip)
        else:
            if callable(lr):
                for group in self.adamw.param_groups:
                    group["lr"] = lr_now
            if skip is not None:
                self.adamw.found_inf = skip.float()
            self.adamw.step()
        self.count = self.count + (1 if skip is None else (~skip).int())

    @torch.no_grad()
    def _update_mu_dtype(self, lr, skip: Optional[torch.Tensor]) -> None:
        """`optax.adamw(lr, weight_decay, mu_dtype=...)` on the trainable
        parameters, in optax's order (`scale_by_adam`,
        `add_decayed_weights`, `scale_by_learning_rate`, `apply_updates`).
        A skipped step (`skip` true) leaves parameters and moments as they
        were.  Each parameter, gradient and moment is a local tensor (a
        shard under FSDP)."""
        held = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [local_tensor(self.params[i]) for i in held]
        mu_old = [self.mu[i] for i in held]
        nu_old = [self.nu[i] for i in held]
        g = [local_tensor(self.params[i].grad).float() for i in held]
        mu = torch._foreach_mul(g, 1 - _B1)
        # optax's b1 * mu: the Python float meets a bf16 array, so b1 is
        # taken in mu's dtype (bf16(0.9) = 0.8984375); under jit the product
        # stays f32 (exact for bf16 operands)
        b1 = float(torch.tensor(_B1, dtype=self.spec.mu_dtype))
        torch._foreach_add_(mu, torch._foreach_mul([m.float() for m in mu_old], b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - _B2)
        torch._foreach_add_(nu, torch._foreach_mul([v.float() for v in nu_old], _B2))
        t = (self.count + 1).float()  # Adam's count after this step
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(_B1, t))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(_B2, t))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, _EPS)
        upd = torch._foreach_div(mu_hat, den)
        if self.spec.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(
                [p.float() for p in params], self.spec.weight_decay))
        torch._foreach_mul_(upd, -lr)
        new_p = torch._foreach_add([p.float() for p in params], upd)
        new_mu = [m.to(self.spec.mu_dtype) for m in mu]
        new_nu = [v.to(o.dtype) for v, o in zip(nu, nu_old)]
        if skip is not None:
            new_p = [torch.where(skip, p, q) for p, q in zip(params, new_p)]
            new_mu = [torch.where(skip, o, m) for o, m in zip(mu_old, new_mu)]
            new_nu = [torch.where(skip, o, v) for o, v in zip(nu_old, new_nu)]
        torch._foreach_copy_(params, new_p)
        torch._foreach_copy_(mu_old, new_mu)
        torch._foreach_copy_(nu_old, new_nu)

    def state_dict(self) -> Dict[str, Any]:
        state = {
            "count": self.count,
            "notfinite_count": self.notfinite_count,
            "total_notfinite": self.total_notfinite,
        }
        if self.adamw is None:
            state.update(mu=self.mu, nu=self.nu)
        else:
            state["adamw"] = self.adamw.state_dict()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """`state` from `state_dict`.  An older checkpoint whose "count"
        is a host int (steps taken, skipped ones included) loads with that
        count taken as the applied steps."""
        if self.adamw is None:
            torch._foreach_copy_(self.mu, list(state["mu"]))
            torch._foreach_copy_(self.nu, list(state["nu"]))
        else:
            self.adamw.load_state_dict(state["adamw"])
        self.count = torch.as_tensor(
            state["count"], dtype=torch.int32, device=self.count.device).clone()
        self.notfinite_count.copy_(state["notfinite_count"])
        self.total_notfinite.copy_(state["total_notfinite"])


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _microbatches(batch: Any, m: int) -> List[Any]:
    def split(x):
        if x.shape[0] % m:
            raise ValueError(
                f"batch axis {x.shape[0]} not divisible by num_microbatches={m}")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])

    parts = _tree_map(split, batch)
    return [_tree_map(lambda x, i=i: x[i], parts) for i in range(m)]


def _mean_aux(auxs: List[Any]) -> Any:
    if not auxs or auxs[0] is None:
        return auxs[0] if auxs else None
    return {k: torch.stack([torch.as_tensor(a[k]) for a in auxs]).mean(0)
            for k in auxs[0]}


def train_step_fn(
    loss_fn: LossFn,
    optimizer: Optimizer,
    num_microbatches: int = 1,
    monitor: bool = False,
    ema_decay: Optional[float] = None,
):
    """Build a step: ``step(model, opt_state, batch, generator, ema=None)
    -> (loss, aux)``, loss a detached device scalar.  `opt_state` is
    ``optimizer.init(model)``; `ema` (with `ema_decay`) a dict of
    parameter name -> tensor, updated in place as ``ema*d + p*(1-d)`` after
    the update.

    num_microbatches > 1: the batch's leading axis is split into that many
    microbatches, each with a generator seeded from `generator`; their
    gradients are summed in f32 and divided by the count, so a mean loss
    gives the full-batch gradient.  monitor: aux gains `grad_norm` and
    `grads_finite` (gradients and loss finite), device scalars.

    Spans, each with CUDA events on a card (`utils/profiling.py`):
    `train.forward` (the loss function), `train.backward` (with a
    microbatch's f32 gradient sums) and `train.update` (norms, finiteness,
    clip, optimizer, EMA)."""
    m = num_microbatches

    def step(model, opt_state, batch, generator, ema=None):
        params = [p for p in model.parameters() if p.requires_grad]
        dev = params[0].device if params else None
        for p in params:
            p.grad = None
        if m > 1:
            acc, losses, auxs = None, [], []
            seeds = [draw_seed(generator) for _ in range(m)]
            for mb, seed in zip(_microbatches(batch, m), seeds):
                with span("train.forward", device=dev):
                    loss, aux = loss_fn(model, mb, torch.Generator().manual_seed(seed))
                with span("train.backward", device=dev):
                    loss.backward()
                    grads = [  # f32 sums
                        torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                        else p.grad.float() for p in params]
                    for p in params:
                        p.grad = None
                    if acc is None:
                        acc = grads
                    else:
                        torch._foreach_add_(acc, grads)
                losses.append(loss.detach())
                auxs.append(aux)
            torch._foreach_div_(acc, float(m))
            for p, a in zip(params, acc):
                p.grad = a.to(p.dtype)
            loss, aux = torch.stack(losses).mean(), _mean_aux(auxs)
        else:
            with span("train.forward", device=dev):
                loss, aux = loss_fn(model, batch, generator)
            with span("train.backward", device=dev):
                loss.backward()
            loss = loss.detach()
        with span("train.update", device=dev):
            grads = [p.grad for p in params if p.grad is not None]
            finite = None
            clip = opt_state.spec.clip_norm
            if monitor or clip or opt_state.spec.max_nonfinite is not None:
                # per-tensor L2 norms: one foreach pass gives both the global
                # norm and the finiteness (a NaN or Inf makes its norm
                # non-finite; an f32 sum of squares past 3e38 counts as bad)
                norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
                finite = torch.isfinite(norms).all()
                norm = torch.linalg.vector_norm(norms)
                if monitor:
                    aux = dict(aux or {})
                    aux["grad_norm"] = norm  # of the unclipped gradients
                    aux["grads_finite"] = finite & torch.isfinite(loss.float()).all()
                if clip:
                    # optax: g where norm < clip, else g / norm * clip
                    torch._foreach_mul_(grads, clip / norm.clamp_min(clip))
            opt_state.update(finite)
            if ema_decay is not None:
                named = dict(model.named_parameters())
                e = list(ema.values())
                torch._foreach_mul_(e, ema_decay)
                torch._foreach_add_(e, [named[n].detach().to(t.dtype) for n, t in ema.items()],
                                    alpha=1.0 - ema_decay)
        return loss, aux

    return step
