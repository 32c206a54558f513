"""Saccadic glimpse embeddings (counterpart of
`msvit_tpu/models/saccadic/embeddings.py`): the dof vector places an
axis-aligned P x P lattice (translation; times exp(s) for scaling, or
diag(exp(s_y), exp(s_x)) for non-uniform scaling), sampled bicubically with
zeros padding (`grid_sample_separable`), projected by one `Linear` over the
flattened glimpse, plus a linear position encoder; a linear position
decoder maps a latent back to a dof vector.  `sample_initial` is the image
center."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from msvit_tpu_torch.models.base.model import Linear
from msvit_tpu_torch.models.saccadic.config import SaccadicViTConfig
from msvit_tpu_torch.ops.grid_sample import grid_sample_separable
from msvit_tpu_torch.utils.math import linspace


class SaccadicViTPatchEmbeddings(nn.Module):
    """Keys: ``projection.*``."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        p, c = config.patch_size, config.num_channels
        self.projection = Linear(p * p * c, config.hidden_size, True, config, generator)

    def _diag(self, patch_config: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        ones = torch.ones(patch_config.shape[:-1] + (2,), device=patch_config.device)
        if cfg.patch_config == "translation":
            return ones
        if cfg.patch_config == "scaling":
            return torch.exp(patch_config[..., 2:3]) * ones
        if cfg.patch_config == "non-uniform-scaling":
            return torch.exp(patch_config[..., 2:4])
        raise ValueError(cfg.patch_config)

    def grid_points(self, patch_config: torch.Tensor) -> torch.Tensor:
        """The glimpse lattice, (y, x)-ordered points [..., P, P, 2]."""
        diag = self._diag(patch_config)
        lin = linspace(-1.0, 1.0, self.config.patch_size, patch_config.device)
        g0, g1 = torch.meshgrid(lin, lin, indexing="ij")
        pts = torch.stack([g0, g1], dim=-1)
        return pts * diag[..., None, None, :] + patch_config[..., None, None, :2]

    def axis_coords(self, patch_config: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ys, xs) [..., P]: the lattice per axis."""
        diag = self._diag(patch_config)
        t = patch_config[..., :2]
        lin = linspace(-1.0, 1.0, self.config.patch_size, patch_config.device)
        return lin * diag[..., 0:1] + t[..., 0:1], lin * diag[..., 1:2] + t[..., 1:2]

    def forward(self, pixel_values: torch.Tensor, patch_config: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, C], patch_config [B, ..., dof] -> [B, ..., D]."""
        ys, xs = self.axis_coords(patch_config)
        patches = grid_sample_separable(pixel_values, ys, xs, "bicubic", "zeros")
        return self.projection(patches.reshape(patches.shape[:-3] + (-1,)))


class SaccadicViTEmbeddings(nn.Module):
    """Patch plus position embedding, and the position decoder.  Keys:
    ``patch_embeddings.projection.*``, ``position_encoder.*``,
    ``position_decoder.*`` (f32)."""

    def __init__(self, config: SaccadicViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        d, dof = config.hidden_size, config.dof
        self.patch_embeddings = SaccadicViTPatchEmbeddings(config, generator)
        self.position_encoder = Linear(dof, d, config.pe_bias, config, generator)
        self.position_decoder = Linear(d, dof, config.pe_bias, config, generator)
        self.position_decoder.compute_dtype = torch.float32

    def sample_initial(self, device=None) -> torch.Tensor:
        """The center glimpse: zeros [dof]."""
        return torch.zeros(self.config.dof, device=device)

    def decode_position(self, latent: torch.Tensor) -> torch.Tensor:
        return self.position_decoder(latent.float())

    def forward(self, pixel_values: torch.Tensor, patch_config: torch.Tensor) -> torch.Tensor:
        emb = self.patch_embeddings(pixel_values, patch_config)
        return emb + self.position_encoder(patch_config.to(self.config.policy.compute))
