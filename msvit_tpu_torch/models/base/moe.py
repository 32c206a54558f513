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
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.model import Linear, trunc_normal


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
        e = self.num_experts
        compute = self.config.policy.compute
        probs, expert, slot = self.route(x)
        gate = probs.gather(-1, expert[..., None])[..., 0]
        frac = F.one_hot(expert.reshape(-1), e).float().mean(0)
        aux = e * (frac * probs.reshape(-1, e).mean(0)).sum()

        xc = x.to(compute)
        w_in, b_in = self.experts_in.to(compute), self.experts_in_bias.to(compute)
        w_out, b_out = self.experts_out.to(compute), self.experts_out_bias.to(compute)
        if self.config.moe_impl == "dense":
            h = torch.einsum("...nd,edf->...nef", xc, w_in) + b_in
            out_e = torch.einsum("...nef,efd->...ned", F.gelu(h), w_out) + b_out
            onehot = F.one_hot(expert, e).float()
            return torch.einsum("...ned,...ne->...nd", out_e,
                                (onehot * gate[..., None]).to(compute)), aux

        lead, (n, d) = x.shape[:-2], x.shape[-2:]
        cap = self.capacity(n)
        xg = xc.reshape(-1, n, d)
        g = xg.shape[0]
        # each kept token's row in [E*C], a dropped token's the spare row E*C
        row = torch.where(slot < cap, expert * cap + slot, e * cap).reshape(g, n, 1)
        rows = row.expand(-1, -1, d)
        queues = xg.new_zeros(g, e * cap + 1, d).scatter(1, rows, xg)
        # expert-major [E, G*C, D]: one bmm per weight, the expert the batch
        # axis (a broadcast matmul over G would copy the weights G times)
        expert_in = queues[:, : e * cap].reshape(g, e, cap, d).transpose(0, 1).reshape(e, -1, d)
        h = F.gelu(torch.bmm(expert_in, w_in) + b_in[:, None, :])
        out_e = torch.bmm(h, w_out) + b_out[:, None, :]  # [E, G*C, D]
        out_e = out_e.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
        picked = torch.cat([out_e, out_e.new_zeros(g, 1, d)], 1).gather(1, rows)
        out = picked * gate.reshape(g, n, 1).to(compute)
        return out.reshape(*lead, n, d), aux
