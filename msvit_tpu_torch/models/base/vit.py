"""Standard ViT assembled from the base trunk (counterpart of
`msvit_tpu/models/base/vit.py`): patch embeddings + encoder + final
LayerNorm (+ optional tanh pooler), and `ViTForImageClassification`, a
linear head on the CLS token.

While training with dropout or stochastic depth, a forward draws one seed
from the `generator` it is given (the default CPU generator when None):
the embeddings' dropout takes `fold_in(seed, 0)`, the trunk
`fold_in(seed, 1)`.

Pixels are NHWC at the public functions, as in the JAX package.  Patchify
is a reshape in (p1, p2, c) order plus one Linear.  Position-embedding
interpolation (a resolution other than the config's) is not ported yet:
JAX uses `jax.image.resize` bicubic, a different kernel from torch's, and
it needs its own parity test (ROADMAP.md queue 1, item 2).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.model import (
    BaseViTEncoder, Linear, dropout, is_stochastic, trunc_normal)
from msvit_tpu_torch.models.base.norm import LayerNorm
from msvit_tpu_torch.utils.rng import draw_seed, fold_in


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, gh*gw, P*P*C], features in (p1, p2, c) order."""
    b, img_h, img_w, c = pixel_values.shape
    p = patch_size
    gh, gw = img_h // p, img_w // p
    x = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def check_grid(config: BaseViTConfig, pixel_values: torch.Tensor) -> None:
    """Raise for channels-first input and for a patch grid that would need
    position-embedding interpolation."""
    _, img_h, img_w, c = pixel_values.shape
    if c != config.num_channels and img_h == config.num_channels:
        raise ValueError(
            f"pixel_values look channels-first {tuple(pixel_values.shape)}; "
            "this framework is NHWC — permute(0, 2, 3, 1) NCHW inputs"
        )
    p = config.patch_size
    if (img_h // p) * (img_w // p) != config.num_patches:
        raise NotImplementedError(
            f"{img_h}x{img_w} px needs position-embedding interpolation "
            "(bicubic), not ported yet (ROADMAP.md queue 1, item 2)"
        )


class ViTEmbeddings(nn.Module):
    """Patchify + (optional) CLS + learned position embeddings."""

    def __init__(self, config: BaseViTConfig, add_cls_token: bool,
                 generator: torch.Generator):
        super().__init__()
        self.config = config
        self.add_cls_token = add_cls_token
        d, p, std = config.hidden_size, config.patch_size, config.initializer_range
        param = config.policy.param
        self.patch_projection = Linear(p * p * config.num_channels, d, True,
                                       config, generator)
        n_pos = config.num_patches + (1 if add_cls_token else 0)
        self.position_embeddings = nn.Parameter(
            trunc_normal((1, n_pos, d), std, generator).to(param))
        if add_cls_token:
            self.cls_token = nn.Parameter(
                trunc_normal((1, 1, d), std, generator).to(param))

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        check_grid(cfg, pixel_values)
        x = self.patch_projection(patchify(pixel_values, cfg.patch_size))
        if self.add_cls_token:
            cls = self.cls_token.expand(x.shape[0], 1, cfg.hidden_size)
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        x = x + self.position_embeddings.to(x.dtype)
        p = cfg.hidden_dropout_prob
        return dropout(x, p, generator) if p > 0 and self.training else x


class ViTModel(nn.Module):
    """Embeddings -> trunk -> final LayerNorm (+ optional pooler).

    Weights are drawn on the CPU from `generator` (seed 0 when None), then
    moved to `device`."""

    def __init__(
        self,
        config: BaseViTConfig,
        add_cls_token: bool = True,
        add_pooler: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        config.check_supported()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.embeddings = ViTEmbeddings(config, add_cls_token, generator)
        self.encoder = BaseViTEncoder(config, generator)
        policy = config.policy
        self.layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   policy.output, policy.param)
        self.add_pooler = add_pooler
        if add_pooler:
            self.pooler_dense = Linear(config.hidden_size, config.hidden_size,
                                       True, config, generator)
        if device is not None:
            self.to(device)

    def forward(
        self,
        pixel_values: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
        output_hidden_states: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        g_emb, seed = None, None
        if self.training and is_stochastic(self.config):
            base = draw_seed(generator)
            g_emb = torch.Generator(pixel_values.device).manual_seed(fold_in(base, 0))
            seed = fold_in(base, 1)
        x = self.embeddings(pixel_values, generator=g_emb)
        x, all_hidden, all_attn = self.encoder(
            x,
            attention_mask=attention_mask,
            output_attentions=output_attentions,
            output_hidden_states=output_hidden_states,
            seed=seed,
        )
        x = self.layernorm(x)
        pooled = None
        if self.add_pooler:
            pooled = torch.tanh(self.pooler_dense(x[:, 0])).to(
                self.config.policy.output)
        return {
            "last_hidden_state": x,
            "pooler_output": pooled,
            "hidden_states": all_hidden,
            "attentions": all_attn,
        }


class ViTForImageClassification(nn.Module):
    """ViT + linear classification head on the CLS token (counterpart of
    the JAX package's `ViTForImageClassification`): state-dict keys under
    ``vit.`` and ``classifier.``; logits in f32.

    Weights are drawn on the CPU from `generator` (seed 0 when None), the
    trunk's first, then moved to `device`."""

    def __init__(
        self,
        config: BaseViTConfig,
        num_labels: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.vit = ViTModel(config, generator=generator)
        self.classifier = Linear(config.hidden_size, num_labels, True, config,
                                 generator)
        if device is not None:
            self.to(device)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pixel_values [B, H, W, C] -> logits [B, num_labels] f32.
        `generator` feeds dropout and stochastic depth while training."""
        x = self.vit(pixel_values, generator=generator)["last_hidden_state"]
        return self.classifier(x[:, 0]).float()
