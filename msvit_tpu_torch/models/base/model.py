"""Base ViT trunk (counterpart of `msvit_tpu/models/base/model.py`).

* pre-LN blocks: ``x += ls1 * attn(LN1(x))``; ``x += ls2 * mlp(LN2(x))``
  (with stochastic depth while training);
* cross-context attention: optional per-layer ``context_states`` are
  concatenated onto K/V only;
* dropout and stochastic depth draw from explicit generators: a block
  given an integer ``seed`` draws its masks from a generator seeded with
  it, so a recomputed block (``config.remat``, `torch.utils.checkpoint`)
  draws the same masks; ``self.training`` stands for JAX's
  ``deterministic=False``;
* masks: bool (True = attend) or additive float;
* LayerNorms in float32, matmuls in the policy's compute dtype.

Parameters live in the policy's param dtype and are cast to the compute
dtype at use, as in the JAX package.  Weights are drawn on the CPU from an
explicit `torch.Generator` (truncated normal at +-2 std, zero biases), so
the same seed gives the same weights on every device.

Self-attention takes the packed path (`ops/packed_attention.py`: K1 for
inference, K1-lse and K2 under autograd) when the JAX package would on its
kernel device: plain self-attention, no probabilities requested, no mask
or a [B, 1|H, N, N] one, and not the masked >= 512-token regime that JAX
sends to its fused/flash kernels.  The three kernels stand for the TPU's
all-heads functions (`_packed_forward`, `_packed_backward`) and for its
head-grouped ones (K8a `_packed_forward_grouped`, K8b
`_packed_backward_grouped`, the 512-1100-token regime: the unmasked ViT-B/8
at 785 tokens), which compute the same function on another grid.  The JAX
package's VMEM fit gates (`packed_vmem_ok`, `grouped_vmem_ok`) are TPU
tiling and are not ported: the unmasked ViT-B/8 at 448 px keeps the packed
path here where JAX falls to flash.  Unlike JAX, which takes the packed
path only on a TPU, the port takes it on every device: on the CPU the
wrappers run the plain versions.

``config.qk_norm``: a per-head LayerNorm over dh (learnable scale, no
bias, f32 statistics) on the queries and on every key, context keys
included.  On the packed path it is a row operation on the QKV GEMM output,
and the 1/sqrt(dh) scale multiplies the normed queries: folded into the
projection it would be erased by the normalisation.

With ``banded_segments`` (the multistate trunk's banded mode) the same
q-prescaled QKV projection goes to `ops/banded_attention.py::
multistate_banded_attention` (K10 for the token rows) instead of a masked
kernel; context states or requested probabilities then raise, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.norm import LayerNorm
from msvit_tpu_torch.ops.attention import multi_head_attention
from msvit_tpu_torch.ops.banded_attention import (
    BandedSegments, multistate_banded_attention)
from msvit_tpu_torch.ops.gelu import gelu_erf, gelu_erf_tanh
from msvit_tpu_torch.ops.packed_attention import packed_attention
from msvit_tpu_torch.utils.rng import draw_seed, fold_in


def trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """f32 CPU draw from N(0, std^2) truncated at +-2 std (flax
    `truncated_normal(stddev=std, lower=-2, upper=2)`)."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax `nn.Dropout`: keep each entry with
    probability 1 - rate and divide it by that; the keep mask is drawn from
    `generator` (the device's default generator when None)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def is_stochastic(config: BaseViTConfig) -> bool:
    """Whether training draws random masks (dropout or stochastic depth)."""
    return (config.hidden_dropout_prob > 0 or config.attention_probs_dropout_prob > 0
            or config.drop_path_rate > 0)


class Linear(nn.Module):
    """Dense layer that computes in the compute dtype, `weight [out, in]`
    (flax `Dense(dtype=compute, param_dtype=param)`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        policy = config.policy
        self.compute_dtype = policy.compute
        self.weight = nn.Parameter(
            trunc_normal((out_features, in_features),
                         config.initializer_range, generator).to(policy.param)
        )
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=policy.param))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.compute_dtype
        b = None if self.bias is None else self.bias.to(c)
        return F.linear(x.to(c), self.weight.to(c), b)


class BaseViTSelfAttention(nn.Module):
    """MHSA with cross-context K/V and bool/additive masks.  The fused QKV
    weight is one `[3*H*dh, D]` Linear, rows in (q|k|v, head, e) order."""

    def __init__(self, config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d, h, dh = config.hidden_size, config.num_attention_heads, config.head_dim
        self.qkv = Linear(d, 3 * h * dh, config.qkv_bias, config, generator)
        self.output_dense = Linear(h * dh, d, True, config, generator)
        # 1/sqrt(dh) on the q third, folded into the projection on the
        # packed path (for dh = 64 the fold multiplies by 0.125: exact)
        qscale = torch.ones(3 * h * dh)
        qscale[: h * dh] = dh**-0.5
        self.register_buffer("qscale", qscale, persistent=False)
        if config.qk_norm:
            policy = config.policy
            self.q_norm = LayerNorm(dh, config.layer_norm_eps, policy.compute,
                                    policy.param, bias=False)
            self.k_norm = LayerNorm(dh, config.layer_norm_eps, policy.compute,
                                    policy.param, bias=False)

    def _use_packed(self, x, context_states, attention_mask, output_attentions):
        cfg = self.config
        if (
            cfg.attn_implementation not in ("auto", "packed")
            or context_states is not None
            or output_attentions
            or x.ndim != 3
        ):
            return False
        if attention_mask is None:
            return True
        n = x.shape[-2]
        if attention_mask.ndim != 4 or tuple(attention_mask.shape[-2:]) != (n, n):
            return False
        # masked mid/long regime: JAX sends it to its fused/flash kernels
        return not (cfg.attn_implementation == "auto" and n >= 512)

    def forward(
        self,
        hidden_states: torch.Tensor,
        context_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
        generator: Optional[torch.Generator] = None,
        banded_segments: Optional[BandedSegments] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        h, dh = cfg.num_attention_heads, cfg.head_dim
        compute = cfg.policy.compute
        x = hidden_states.to(compute)
        p_drop = cfg.attention_probs_dropout_prob if self.training else 0.0
        if banded_segments is not None and (
                context_states is not None or output_attentions or x.ndim != 3):
            # never drop the cluster structure silently (no dense mask was
            # passed in banded mode)
            raise ValueError("banded_segments requires plain self-attention "
                             "without output_attentions")

        if banded_segments is not None or self._use_packed(
                x, context_states, attention_mask, output_attentions):
            if cfg.qk_norm:
                # the norm is scale-invariant: 1/sqrt(dh) goes on the normed
                # queries, not into the projection (`qscale` unused here)
                qkvp = self.qkv(x)
                q, k, v = qkvp.unflatten(-1, (3, h, dh)).unbind(-3)
                qkvp = torch.stack(
                    [self.q_norm(q) * dh**-0.5, self.k_norm(k), v], dim=-3
                ).reshape(qkvp.shape)
            else:
                qs = self.qscale.to(compute)
                w = self.qkv.weight.to(compute) * qs[:, None]
                b = None if self.qkv.bias is None else self.qkv.bias.to(compute) * qs
                qkvp = F.linear(x, w, b)
            if banded_segments is not None:
                out = multistate_banded_attention(qkvp, banded_segments, h)
            else:
                out = packed_attention(qkvp, h, mask=attention_mask, scale=1.0)
            out = dropout(out, p_drop, generator) if p_drop > 0 else out
            out = self.output_dense(out)
            return self._hidden_dropout(out, generator), None

        qkv = self.qkv(x).unflatten(-1, (3, h, dh))  # [..., N, 3, H, dh]
        q, k, v = (qkv.select(-3, t).transpose(-3, -2) for t in range(3))
        if context_states is not None:
            # K/V see [hidden ++ context]; queries do not
            c = context_states.to(compute)
            wkv = self.qkv.weight.to(compute)[h * dh:]
            bkv = None if self.qkv.bias is None else self.qkv.bias.to(compute)[h * dh:]
            ckv = F.linear(c, wkv, bkv).unflatten(-1, (2, h, dh))
            k = torch.cat([k, ckv.select(-3, 0).transpose(-3, -2)], dim=-2)
            v = torch.cat([v, ckv.select(-3, 1).transpose(-3, -2)], dim=-2)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)

        out, probs = multi_head_attention(
            q, k, v, mask=attention_mask,
            implementation=cfg.attn_implementation,
            output_probs=output_attentions,
        )
        out = dropout(out, p_drop, generator) if p_drop > 0 else out
        out = out.transpose(-3, -2).reshape(*hidden_states.shape[:-1], h * dh)
        out = self.output_dense(out)
        return self._hidden_dropout(out, generator), probs

    def _hidden_dropout(self, out, generator):
        p = self.config.hidden_dropout_prob
        return dropout(out, p, generator) if p > 0 and self.training else out


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":  # tanh-form erf GELU, the serving GELU
        return gelu_erf_tanh(x)
    if name == "gelu_as":  # Abramowitz–Stegun erf
        return gelu_erf(x)
    if name == "gelu_xla_erf":  # the framework's own exact-erf GELU
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return getattr(F, name)(x)


class BaseMLP(nn.Module):
    """GELU MLP, hidden = hidden_size * mlp_ratio."""

    def __init__(self, config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        self.act = config.hidden_act
        self.fc1 = Linear(config.hidden_size, config.mlp_hidden_size, True,
                          config, generator)
        self.fc2 = Linear(config.mlp_hidden_size, config.hidden_size, True,
                          config, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if torch.is_grad_enabled() and h.requires_grad:
            # keep only the GELU's input for the backward and recompute the
            # formula there: autograd would otherwise keep ~7 f32 [B, N,
            # 4D] temporaries of the elementwise erf per layer (the JAX
            # package's XLA fusion keeps none)
            a = torch.utils.checkpoint.checkpoint(
                _activation, self.act, h, use_reentrant=False)
        else:
            a = _activation(self.act, h)
        return self.fc2(a)


class BaseSwiGLUFFN(nn.Module):
    def __init__(self, config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        hidden = config.swiglu_hidden_size
        self.weights_in = Linear(config.hidden_size, 2 * hidden, True, config,
                                 generator)
        self.weights_out = Linear(hidden, config.hidden_size, True, config,
                                  generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


def _drop_path(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (training only)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.floor(keep + torch.rand(shape, generator=generator, device=x.device))
    return (x / keep) * mask.to(x.dtype)


class BaseViTLayer(nn.Module):
    """Pre-LN transformer block with LayerScale."""

    def __init__(self, config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        config.check_supported()
        self.config = config
        d, policy = config.hidden_size, config.policy
        self.norm1 = LayerNorm(d, config.layer_norm_eps, policy.compute, policy.param)
        self.attention = BaseViTSelfAttention(config, generator)
        self.layer_scale1 = nn.Parameter(
            torch.full((d,), config.layerscale_value, dtype=policy.param))
        self.norm2 = LayerNorm(d, config.layer_norm_eps, policy.compute, policy.param)
        mlp_cls = BaseSwiGLUFFN if config.use_swiglu_ffn else BaseMLP
        self.mlp = mlp_cls(config, generator)
        self.layer_scale2 = nn.Parameter(
            torch.full((d,), config.layerscale_value, dtype=policy.param))

    def _branch(self, y, ls, generator):
        y = y * ls.to(y.dtype)
        rate = self.config.drop_path_rate
        return _drop_path(y, rate, generator) if rate > 0 and self.training else y

    def forward(
        self,
        hidden_states: torch.Tensor,
        context_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
        seed: Optional[int] = None,
        banded_segments: Optional[BandedSegments] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`seed`: the block's masks (dropout, stochastic depth, in that
        order) come from a generator seeded with it; None draws them from
        the device's default generator.  `banded_segments`: the multistate
        cluster structure of a cluster-sorted sequence, in place of a mask
        (the attention runs `multistate_banded_attention`)."""
        g = None
        if seed is not None and self.training and is_stochastic(self.config):
            g = torch.Generator(hidden_states.device).manual_seed(seed)
        attn_out, probs = self.attention(
            self.norm1(hidden_states), context_states=context_states,
            attention_mask=attention_mask, output_attentions=output_attentions,
            generator=g, banded_segments=banded_segments,
        )
        hidden_states = self._branch(attn_out, self.layer_scale1, g) + hidden_states
        mlp_out = self.mlp(self.norm2(hidden_states))
        hidden_states = self._branch(mlp_out, self.layer_scale2, g) + hidden_states
        return hidden_states, probs


class BaseViTEncoder(nn.Module):
    """Stack of blocks, with optional per-layer context states.  Under
    ``config.remat`` each block is recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant), the counterpart of JAX's
    `nn.remat` with no policy (full recompute)."""

    def __init__(self, config: BaseViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        self.layer = nn.ModuleList(
            BaseViTLayer(config, generator) for _ in range(config.num_hidden_layers)
        )

    def forward(
        self,
        hidden_states: torch.Tensor,
        context_states: Optional[Sequence[Optional[torch.Tensor]]] = None,
        attention_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
        output_hidden_states: bool = False,
        seed: Optional[int] = None,
    ):
        """`seed`: block i draws its masks from `fold_in(seed, i)`; None
        while training with dropout or stochastic depth draws one seed from
        the default CPU generator."""
        cfg = self.config
        if seed is None and self.training and is_stochastic(cfg):
            seed = draw_seed(None)
        remat = cfg.remat and torch.is_grad_enabled()
        all_hidden = [] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        for i, layer in enumerate(self.layer):
            if output_hidden_states:
                all_hidden.append(hidden_states)
            ctx = context_states[i] if context_states is not None else None
            args = (hidden_states, ctx, attention_mask, output_attentions,
                    None if seed is None else fold_in(seed, i))
            if remat:
                # the block's masks come from its seed, not from the global
                # RNG, so the RNG state need not be saved for the recompute
                hidden_states, probs = torch.utils.checkpoint.checkpoint(
                    layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                hidden_states, probs = layer(*args)
            if output_attentions:
                all_attn.append(probs)
        if output_hidden_states:
            all_hidden.append(hidden_states)
        return hidden_states, all_hidden, all_attn
