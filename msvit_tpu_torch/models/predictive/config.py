"""Predictive encoder configs (counterpart of
`msvit_tpu/models/predictive/config.py`, field for field and default for
default)."""

from __future__ import annotations

import dataclasses

from msvit_tpu_torch.models.base.config import BaseViTConfig

# degrees of freedom per glimpse parameterization
PATCH_CONFIG_DOF = {
    "translation": 2,
    "scaling": 3,
    "non-uniform-scaling": 4,
}


@dataclasses.dataclass(frozen=True)
class PredictiveViTConfig(BaseViTConfig):
    use_cls_token: bool = True
    image_size: int = 224
    patch_size: int = 64  # glimpse resolution, not a tiling patch
    patch_config: str = "scaling"
    default_patch_scale: float = 0.5
    patch_config_distribution: str = "uniform"
    # scalar, or per-dof (scale, shift) rows as a tuple of tuples
    patch_config_scale: object = 1.0
    pe_bias: bool = False
    expected_context_length: float = 2.0
    # static bound on the context length (the token axis is static)
    max_context_length: int = 8

    @property
    def dof(self) -> int:
        return PATCH_CONFIG_DOF[self.patch_config]

    @property
    def seq_length(self) -> int:
        # [CLS, ctx_1..ctx_max, PRD]
        return self.max_context_length + 2


@dataclasses.dataclass(frozen=True)
class PredictiveViTTrainingConfig:
    """Loss weights (0 = off); any real number weighs its loss."""

    preservation: float = 0.0
    context_prediction: float = 0.0
    query_prediction: float = 0.0
    context_patch_prediction: float = 0.0
    query_patch_prediction: float = 0.0
    positional_recovery: float = 0.0
    positional_regularization: float = 0.0
    # divide the three latent-space losses (preservation, context/query
    # prediction) by the detached mean second moment of the input
    # embeddings (needs the forward's `output_inputs=True`)
    normalize_latent: bool = False
