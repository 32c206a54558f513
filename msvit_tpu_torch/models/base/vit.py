"""Standard ViT assembled from the base trunk (counterpart of
`msvit_tpu/models/base/vit.py`): patch embeddings + encoder + final
LayerNorm (+ optional tanh pooler), and `ViTForImageClassification`, a
linear head on the CLS token.

While training with dropout or stochastic depth, a forward draws one seed
from the `generator` it is given (the default CPU generator when None):
the embeddings' dropout takes `fold_in(seed, 0)`, the trunk
`fold_in(seed, 1)`.

Pixels are NHWC at the public functions, as in the JAX package.  Patchify
is a reshape in (p1, p2, c) order plus one Linear.  At a resolution other
than the config's the position table is resampled to the patch grid
(`interpolate_pos_embed`, the JAX package's `jax.image.resize` bicubic,
which is not `F.interpolate`'s bicubic).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5 at distances x >= 0 (JAX's
    `_fill_keys_cubic_kernel`; torch's bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] f32 weights of JAX's bicubic `jax.image.resize` along
    one axis (`compute_weight_mat` with antialias): half-pixel centres,
    the kernel widened by the scale when shrinking, each output's weights
    normalised to sum 1, outputs whose centre falls outside the input
    zero."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / max(inv_scale, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches: int,
                          grid_hw: Tuple[int, int],
                          has_cls: bool = True) -> torch.Tensor:
    """Bicubic-resample a [1, N(+1), D] position table to the patch grid
    `grid_hw` (the JAX package's `interpolate_pos_embed`): the table's
    square grid goes through `resize_weights` along each axis whose length
    changes (two einsums in f32); the CLS row is kept.  A table that
    already holds `num_patches` rows is returned as it is."""
    n_table = pos_embed.shape[1] - (1 if has_cls else 0)
    if n_table == num_patches:
        return pos_embed
    grid = (pos_embed[:, 1:] if has_cls else pos_embed).float()
    d = grid.shape[-1]
    old = int(round(n_table**0.5))
    gh, gw = grid_hw
    grid = grid.reshape(old, old, d)
    if gh != old:
        grid = torch.einsum("hwd,hy->ywd", grid, resize_weights(old, gh, grid.device))
    if gw != old:
        grid = torch.einsum("ywd,wx->yxd", grid, resize_weights(old, gw, grid.device))
    grid = grid.reshape(1, gh * gw, d).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], grid], dim=1) if has_cls else grid


def check_grid(config: BaseViTConfig, pixel_values: torch.Tensor) -> Tuple[int, int]:
    """The patch grid (gh, gw) of NHWC `pixel_values`; raises for
    channels-first input."""
    _, img_h, img_w, c = pixel_values.shape
    if c != config.num_channels and img_h == config.num_channels:
        raise ValueError(
            f"pixel_values look channels-first {tuple(pixel_values.shape)}; "
            "this framework is NHWC — permute(0, 2, 3, 1) NCHW inputs"
        )
    return img_h // config.patch_size, img_w // config.patch_size


def grid_position_table(pos_embed: torch.Tensor, config: BaseViTConfig,
                        pixel_values: torch.Tensor, has_cls: bool) -> torch.Tensor:
    """`pos_embed` for the patch grid of `pixel_values` (checked by
    `check_grid`): resampled where its rows differ from the grid's
    patches, as JAX's embeddings do."""
    gh, gw = check_grid(config, pixel_values)
    return interpolate_pos_embed(pos_embed, gh * gw, (gh, gw), has_cls)


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
        pos = grid_position_table(self.position_embeddings, cfg, pixel_values,
                                  self.add_cls_token)
        x = self.patch_projection(patchify(pixel_values, cfg.patch_size))
        if self.add_cls_token:
            cls = self.cls_token.expand(x.shape[0], 1, cfg.hidden_size)
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        x = x + pos.to(x.dtype)
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
            # per-layer Switch losses of an MoE trunk (empty without experts)
            "moe_aux_loss": self.encoder.moe_aux_loss,
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
