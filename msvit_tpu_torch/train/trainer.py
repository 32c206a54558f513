"""Training loop (counterpart of `msvit_tpu/train/trainer.py`): the step,
checkpointing and metrics."""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch
from torch import nn

from msvit_tpu_torch.train.checkpoint import CheckpointManager
from msvit_tpu_torch.train.loop import (
    LossFn, Optimizer, apply_if_finite, train_step_fn)
from msvit_tpu_torch.utils.metrics import MetricsLogger
from msvit_tpu_torch.utils.profiling import span
from msvit_tpu_torch.utils.rng import fold_in


class Trainer:
    """loss_fn(model, batch, generator) -> (scalar, aux dict of scalars).

    The model and `optimizer.init(model)` are updated in place.  With
    `monitor`, non-finite steps are skipped on the device (optax
    `apply_if_finite(optimizer, max_nonfinite)`) and `grad_norm` /
    `grads_finite` reach the metrics.  With `ema_decay`, `ema_params`
    (parameter name -> tensor) tracks an exponential moving average of the
    parameters; it is checkpointed and restored with them.  The host reads
    the loss only at log boundaries.

    Spans (`utils/profiling.py`): `train.step` around each step, with the
    step function's `train.forward`, `train.backward` and `train.update`
    inside it, and at a log boundary `train.log`, whose host reads are
    `sync.loss_read` and `sync.metrics_read`."""

    def __init__(
        self,
        loss_fn: LossFn,
        optimizer: Optimizer,
        model: nn.Module,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 1000,
        metrics_path: Optional[str] = None,
        log_every: int = 25,
        num_microbatches: int = 1,
        monitor: bool = False,
        max_nonfinite: int = 10,
        ema_decay: Optional[float] = None,
    ):
        if monitor:
            optimizer = apply_if_finite(optimizer, max_nonfinite)
        self.step_fn = train_step_fn(
            loss_fn, optimizer, num_microbatches=num_microbatches,
            monitor=monitor, ema_decay=ema_decay,
        )
        self.model = model
        self.opt_state = optimizer.init(model)
        self.ema_decay = ema_decay
        self.ema_params = (
            {n: p.detach().clone() for n, p in model.named_parameters()}
            if ema_decay is not None
            else None
        )
        self.step = 0
        self.log_every = log_every
        self.ckpt = (
            CheckpointManager(checkpoint_dir, save_every=save_every)
            if checkpoint_dir
            else None
        )
        self.metrics = MetricsLogger(metrics_path) if metrics_path else None

    def _snapshot(self, data_iter: Any) -> dict:
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.opt_state.state_dict(),
            "step": self.step,
        }
        if hasattr(data_iter, "state_dict"):
            state["data"] = data_iter.state_dict()
        if self.ema_params is not None:
            state["ema"] = self.ema_params
        return state

    def restore(self, data_iter: Any = None) -> int:
        """Resume from the latest checkpoint, if any.  Returns the step.

        Pass the training iterator as `data_iter` when it is stateful
        (`state_dict` / `load_state_dict`): its position is restored too,
        so the resumed run consumes the batches the interrupted run
        would have."""
        if self.ckpt is None:
            return 0
        step, state = self.ckpt.restore_latest()
        if state is None:
            return self.step
        self.model.load_state_dict(state["model"])
        self.opt_state.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if data_iter is not None and hasattr(data_iter, "load_state_dict") and "data" in state:
            data_iter.load_state_dict({k: int(v) for k, v in state["data"].items()})
        if self.ema_params is not None:
            for n, t in state["ema"].items():
                self.ema_params[n].copy_(t)
        return self.step

    def fit(self, batches: Iterable[Any], num_steps: int, seed: int) -> float:
        """Run up to `num_steps` updates; returns the last logged loss.

        Step s draws from a generator seeded with `fold_in(seed, s)` (not
        a running stream), so a resumed run replays the interrupted run's
        draws exactly."""
        loss = float("nan")
        for batch in batches:
            if self.step >= num_steps:
                break
            with span("train.step", step=self.step):
                gen = torch.Generator().manual_seed(fold_in(seed, self.step))
                loss_dev, aux = self.step_fn(
                    self.model, self.opt_state, batch, gen, self.ema_params)
                self.step += 1
                if self.step % self.log_every == 0 or self.step == num_steps:
                    with span("train.log"):
                        with span("sync.loss_read"):
                            loss = float(loss_dev)  # the host's only read of the step
                        if self.metrics:
                            with span("sync.metrics_read"):
                                scalars = {
                                    k: float(v) for k, v in (aux or {}).items()
                                    if k != "loss" and torch.as_tensor(v).ndim == 0
                                }
                            self.metrics.log(self.step, loss=loss, **scalars)
                if self.ckpt:
                    self.ckpt.maybe_save(self.step, self._snapshot(batches))
        if self.ckpt:
            self.ckpt.close()
        if self.metrics:
            self.metrics.close()
        return loss
