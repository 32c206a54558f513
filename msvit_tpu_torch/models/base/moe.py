"""Mixture-of-experts FFN, token-choice top-1 (counterpart of
`msvit_tpu/models/base/moe.py`).

The router runs in f32: softmax over E experts, each token goes to its
argmax (the first maximum on ties, as `jnp.argmax`) with gate = its
probability, cast to the compute dtype before the combine.  The Switch
load-balancing loss ``E * sum_e fraction_e * mean_prob_e`` comes back
beside the output.  The expert FFN is the exact erf GELU whatever
``config.hidden_act`` says.  Parameters keep the JAX layout:
``router.weight [E, D]`` (a Linear), ``experts_in [E, D, F]``,
``experts_in_bias [E, F]``, ``experts_out [E, F, D]``,
``experts_out_bias [E, D]``.

``config.moe_impl``:

* ``"dispatch"``: each token takes the next slot of its expert's queue of
  capacity ``C = min(ceil(capacity_factor * N / E), N)`` per image; a token
  past the capacity is dropped (its output is zero; the residual carries
  it).  JAX dispatches and combines by one-hot einsums, where a token past
  the capacity has slot >= C and `jax.nn.one_hot` gives it a zero row;
  here dispatch is a scatter of the kept tokens into ``[G, E*C, D]`` and
  combine a gather of their rows, the same selection (a dropped token
  points at one spare row that is thrown away, so nothing raises or
  wraps).  The per-expert GEMMs ``[E, G*C, D] x [E, D, F]`` are `torch.bmm`
  with the expert as the batch axis (XLA einsums in JAX, outside any
  Pallas kernel).
* ``"dense"``: every expert on every token, masked by the gated one-hot.

Expert parallelism (``.tp``, set by `parallel.parallelize`): the expert
tensors hold this rank's E/tp experts.  Routing, the aux loss and the
dispatch stay replicated; each rank computes the queues of its experts,
the combine (each token's row, zero where another rank's expert has it) is
summed over the group, and only then multiplied by the gate, so the sum
adds zeros: the sharded layer gives the replicated layer's numbers.  Under
sequence sharding the layer gathers its tokens first and hands back this
rank's chunk.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.model import Linear, trunc_normal
from msvit_tpu_torch.parallel.collectives import (
    ModelParallel, copy_to_model, gather_tokens_replicated, reduce_from_model,
    split_tokens)


class MoEFFN(nn.Module):
    """Top-1 token-choice MoE GELU FFN."""

    def __init__(self, config: BaseViTConfig, num_experts: int,
                 generator: torch.Generator):
        super().__init__()
        self.config = config
        d, f, e = config.hidden_size, config.mlp_hidden_size, num_experts
        param, std = config.policy.param, config.initializer_range
        self.num_experts = e
        self.router = Linear(d, e, True, config, generator)
        self.router.compute_dtype = torch.float32
        self.experts_in = nn.Parameter(trunc_normal((e, d, f), std, generator).to(param))
        self.experts_in_bias = nn.Parameter(torch.zeros(e, f, dtype=param))
        self.experts_out = nn.Parameter(trunc_normal((e, f, d), std, generator).to(param))
        self.experts_out_bias = nn.Parameter(torch.zeros(e, d, dtype=param))
        self.tp: Optional[ModelParallel] = None

    def capacity(self, n: int) -> int:
        """Slots per expert and image for `n` tokens."""
        cap = max(1, math.ceil(self.config.moe_capacity_factor * n / self.num_experts))
        return min(cap, n)

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [..., N, D] -> (router probabilities [..., N, E] f32, expert
        [..., N], queue slot [..., N]: the token's 0-based place in its
        expert's queue; it is dropped when slot >= `capacity(N)`)."""
        probs = torch.softmax(self.router(x.float()), dim=-1)
        expert = probs.argmax(-1)
        slot = (F.one_hot(expert, self.num_experts).cumsum(-2) - 1).gather(
            -1, expert[..., None])[..., 0]
        return probs, expert, slot

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., N, D] -> (out [..., N, D] compute dtype, aux loss [] f32)."""
        tp = self.tp
        if tp is not None:
            return self._forward_parallel(x, tp)
        e = self.num_experts
        compute = self.config.policy.compute
        probs, expert, slot = self.route(x)
        gate = probs.gather(-1, expert[..., None])[..., 0]
        aux = self._aux(probs, expert)

        xc = x.to(compute)
        w_in, b_in = self.experts_in.to(compute), self.experts_in_bias.to(compute)
        w_out, b_out = self.experts_out.to(compute), self.experts_out_bias.to(compute)
        if self.config.moe_impl == "dense":
            h = torch.einsum("...nd,edf->...nef", xc, w_in) + b_in
            out_e = torch.einsum("...nef,efd->...ned", F.gelu(h), w_out) + b_out
            onehot = F.one_hot(expert, e).float()
            return torch.einsum("...ned,...ne->...nd", out_e,
                                (onehot * gate[..., None]).to(compute)), aux
        picked = self._dispatch(xc, expert, slot, w_in, b_in, w_out, b_out, 0)
        out = picked * gate.reshape(picked.shape[:2] + (1,)).to(compute)
        return out.reshape(x.shape[:-1] + (x.shape[-1],)), aux

    def _aux(self, probs: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
        e = self.num_experts
        frac = F.one_hot(expert.reshape(-1), e).float().mean(0)
        return e * (frac * probs.reshape(-1, e).mean(0)).sum()

    def _dispatch(self, xc, expert, slot, w_in, b_in, w_out, b_out, e0):
        """Each kept token's output row of the experts [e0, e0 + len(w_in))
        ([G, N, D]; zero for a dropped token or another expert's)."""
        e, el = self.num_experts, w_in.shape[0]
        n, d = xc.shape[-2:]
        cap = self.capacity(n)
        xg = xc.reshape(-1, n, d)
        g = xg.shape[0]
        # each kept token's row in [E*C], a dropped token's the spare row E*C
        row = torch.where(slot < cap, expert * cap + slot, e * cap).reshape(g, n, 1)
        rows = row.expand(-1, -1, d)
        queues = xg.new_zeros(g, e * cap + 1, d).scatter(1, rows, xg)
        # expert-major [E, G*C, D]: one bmm per weight, the expert the batch
        # axis (a broadcast matmul over G would copy the weights G times)
        expert_in = queues[:, : e * cap].reshape(g, e, cap, d)[:, e0:e0 + el]
        expert_in = expert_in.transpose(0, 1).reshape(el, -1, d)
        h = F.gelu(torch.bmm(expert_in, w_in) + b_in[:, None, :])
        out_e = torch.bmm(h, w_out) + b_out[:, None, :]  # [El, G*C, D]
        out_e = out_e.reshape(el, g, cap, d).transpose(0, 1)
        if el < e:  # another rank's experts: zero rows
            out_e = torch.cat([out_e.new_zeros(g, e0, cap, d), out_e,
                               out_e.new_zeros(g, e - e0 - el, cap, d)], 1)
        out_e = out_e.reshape(g, e * cap, d)
        return torch.cat([out_e, out_e.new_zeros(g, 1, d)], 1).gather(1, rows)

    def _forward_parallel(self, x: torch.Tensor, tp: ModelParallel):
        """Expert parallelism: this rank's experts, the combine summed over
        the group before the gate (see the module's docstring)."""
        compute = self.config.policy.compute
        if tp.seq:  # the router reads every token alike on every rank
            x = gather_tokens_replicated(x, tp, tp.tokens)
        probs, expert, slot = self.route(x)
        gate = probs.gather(-1, expert[..., None])[..., 0].to(compute)
        aux = self._aux(probs, expert)
        xc = copy_to_model(x.to(compute), tp)
        el = self.experts_in.shape[0]
        e0 = tp.rank * el
        w_in, b_in = self.experts_in.to(compute), self.experts_in_bias.to(compute)
        w_out, b_out = self.experts_out.to(compute), self.experts_out_bias.to(compute)
        if self.config.moe_impl == "dense":
            h = torch.einsum("...nd,edf->...nef", xc, w_in) + b_in
            out_e = torch.einsum("...nef,efd->...ned", F.gelu(h), w_out) + b_out
            onehot = F.one_hot(expert, self.num_experts)[..., e0:e0 + el].to(compute)
            part = torch.einsum("...ned,...ne->...nd", out_e, onehot)
        else:
            part = self._dispatch(xc, expert, slot, w_in, b_in, w_out, b_out, e0)
            part = part.reshape(x.shape[:-1] + (x.shape[-1],))
        out = reduce_from_model(part, tp) * gate[..., None]
        return (split_tokens(out, tp) if tp.seq else out), aux
