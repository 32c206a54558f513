"""Saccadic transformer refiner (counterpart of
`msvit_tpu/models/saccadic/refiner.py`).

* `QuadraticSelfAttention`: scores (QK^T - 1/2 |dist(q) - dist(k)|^2) /
  sqrt(dh) through a shared `distance` projection;
* `EagerSelfAttention`: plain MHSA through `multi_head_attention`'s plain
  path ("xla"), as in JAX: the refiner's sequences are a few glimpses long;
* `SaccadicViTLayer` / `SaccadicViTEncoder`: post-LN blocks, x += attn(x);
  x = mlp(LN(x)) + x;
* `TransformerSaccadicViTPredictor`: per-pattern learned tokens and a block
  mask joining each pattern token to the hidden nodes it matched (and to
  itself); encodes [tokens ++ pattern tokens].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msvit_tpu_torch.models.base.model import Linear
from msvit_tpu_torch.models.base.norm import LayerNorm
from msvit_tpu_torch.models.saccadic.config import SaccadicViTConfig
from msvit_tpu_torch.ops.attention import DEFAULT_MASK_VALUE, multi_head_attention


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[..., N, H*dh] -> [..., H, N, dh]."""
    return x.unflatten(-1, (h, -1)).transpose(-3, -2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[..., H, N, dh] -> [..., N, H*dh]."""
    return x.transpose(-3, -2).flatten(-2)


class QuadraticSelfAttention(nn.Module):
    """Keys: ``query.*``, ``key.*``, ``value.*``, ``distance.weight`` (no
    bias)."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d, hd = config.hidden_size, config.num_attention_heads * config.head_dim
        self.query = Linear(d, hd, True, config, generator)
        self.key = Linear(d, hd, True, config, generator)
        self.value = Linear(d, hd, True, config, generator)
        self.distance = Linear(d, hd, False, config, generator)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attention_mask: bool [..., Nq, Nk], True = attend."""
        cfg = self.config
        h, dh = cfg.num_attention_heads, cfg.head_dim
        x = hidden_states.to(cfg.policy.compute)
        q, k, v = (_heads(p(x), h) for p in (self.query, self.key, self.value))
        dq = _heads(self.distance(x), h).float()
        # -1/2 |dq_i - dk_j|^2 = dq.dk - 1/2 (|dq|^2 + |dk|^2), dk = dq
        sq = 0.5 * (dq**2).sum(-1)
        quad = dq @ dq.transpose(-1, -2) - sq[..., :, None] - sq[..., None, :]
        lin = q.float() @ k.float().transpose(-1, -2)
        scores = (quad + lin) / dh**0.5
        if attention_mask is not None:
            scores = scores.masked_fill(~attention_mask[..., None, :, :], DEFAULT_MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        out = (probs.to(v.dtype).float() @ v.float()).to(cfg.policy.compute)
        return _merge(out)


class EagerSelfAttention(nn.Module):
    """Keys: ``query.*``, ``key.*``, ``value.*``."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d, hd = config.hidden_size, config.num_attention_heads * config.head_dim
        self.query = Linear(d, hd, True, config, generator)
        self.key = Linear(d, hd, True, config, generator)
        self.value = Linear(d, hd, True, config, generator)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        h = cfg.num_attention_heads
        x = hidden_states.to(cfg.policy.compute)
        q, k, v = (_heads(p(x), h) for p in (self.query, self.key, self.value))
        mask = None if attention_mask is None else attention_mask[..., None, :, :]
        out, _ = multi_head_attention(q, k, v, mask=mask, implementation="xla")
        return _merge(out)


class SaccadicViTLayer(nn.Module):
    """A post-LN block.  Keys: ``attention.*``, ``output_dense.*``,
    ``layernorm_after.*``, ``intermediate.*``, ``output.*``."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d, policy = config.hidden_size, config.policy
        attn = (QuadraticSelfAttention if config.refiner_attention == "quadratic"
                else EagerSelfAttention)
        self.attention = attn(config, generator)
        self.output_dense = Linear(config.num_attention_heads * config.head_dim, d, True,
                                   config, generator)
        self.layernorm_after = LayerNorm(d, config.layer_norm_eps, policy.compute,
                                         policy.param)
        self.intermediate = Linear(d, config.mlp_hidden_size, True, config, generator)
        self.output = Linear(config.mlp_hidden_size, d, True, config, generator)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.output_dense(self.attention(hidden_states, attention_mask)) \
            + hidden_states
        x = F.gelu(self.intermediate(self.layernorm_after(hidden_states)))
        return self.output(x) + hidden_states


class SaccadicViTEncoder(nn.Module):
    """Keys: ``layer.<i>.*``."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.layer = nn.ModuleList(SaccadicViTLayer(config, generator)
                                   for _ in range(config.num_hidden_layers))

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layer:
            hidden_states = layer(hidden_states, attention_mask)
        return hidden_states


class TransformerSaccadicViTPredictor(nn.Module):
    """The refiner over [hidden tokens ++ matched pattern tokens].  Keys:
    ``cls_tokens_<K> [V, D]`` (N(0, 1)) for each (K, V) of `num_patterns`,
    ``encoder.*``."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        for k, v in config.num_patterns:
            setattr(self, f"cls_tokens_{k}", nn.Parameter(
                torch.randn((v, config.hidden_size), generator=generator)))
        self.encoder = SaccadicViTEncoder(config, generator)

    def predicted_states(self, pattern: Dict[str, torch.Tensor],
                         log_covariance_shift: torch.Tensor,
                         prediction_method: str = "max", rng=None) -> torch.Tensor:
        """The conditional mean ("max"), or ("mean") the mean plus explicit
        low-rank noise and implicit isotropic noise drawn from `rng` (an
        `Rng`, split in two as JAX splits its key)."""
        mean = pattern["conditional_mean"]  # [B, W, n_wild, D]
        if prediction_method == "max":
            return mean
        if prediction_method == "mean":
            if rng is None:
                raise ValueError("prediction_method='mean' needs an rng")
            k1, k2 = rng.split(2)
            cov = pattern["conditional_covariance"]
            eps = k1.normal(mean.shape[:-1] + (cov.shape[-1], 1), mean.device)
            explicit = (cov @ eps)[..., 0]
            implicit = torch.exp(0.5 * log_covariance_shift) * k2.normal(mean.shape,
                                                                         mean.device)
            return mean + explicit + implicit
        raise ValueError(prediction_method)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, N, D]
        context_states: torch.Tensor,  # [B, C, D]
        patterns: Dict[Tuple[int, int], Dict[str, torch.Tensor]],
    ) -> Tuple[torch.Tensor, Dict[Tuple[int, int], torch.Tensor]]:
        b, n, _ = hidden_states.shape
        dev = hidden_states.device
        tokens, rows, slices = [], [], [0]
        for (complexity, _), p in patterns.items():
            tok = getattr(self, f"cls_tokens_{complexity}")[p["pattern_index"]]  # [B, W, D]
            tokens.append(tok)
            # a pattern token attends to the hidden nodes it matched
            rows.append((p["node_indices"][..., None]
                         == torch.arange(n, device=dev)).any(-2))  # [B, W, N]
            slices.append(slices[-1] + tok.shape[1])
        pattern_tokens = torch.cat(tokens, dim=1)  # [B, P, D]
        a = torch.cat(rows, dim=1)  # [B, P, N]
        n_p = pattern_tokens.shape[1]
        # [[False (N, N), A^T], [A, I]]
        top = torch.cat([torch.zeros(b, n, n, dtype=torch.bool, device=dev),
                         a.transpose(1, 2)], dim=-1)
        eye = torch.eye(n_p, dtype=torch.bool, device=dev).expand(b, n_p, n_p)
        mask = torch.cat([top, torch.cat([a, eye], dim=-1)], dim=1)
        encoded = self.encoder(
            torch.cat([hidden_states, pattern_tokens.to(hidden_states.dtype)], dim=1), mask)
        out = {key: encoded[:, n + slices[i]: n + slices[i + 1]]
               for i, key in enumerate(patterns)}
        return encoded[:, :n], out
