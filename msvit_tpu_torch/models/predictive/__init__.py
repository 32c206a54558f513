"""Predictive encoder: variable-length sequences of glimpses placed by
affine parameters; the trunk predicts embeddings, positions and patches at
predicted locations (counterpart of `msvit_tpu/models/predictive/`)."""

from msvit_tpu_torch.models.predictive.config import (
    PATCH_CONFIG_DOF,
    PredictiveViTConfig,
    PredictiveViTTrainingConfig,
)
from msvit_tpu_torch.models.predictive.losses import LOSS2FN, patch_mean_bar, training_loss
from msvit_tpu_torch.models.predictive.model import PredictiveViTModel

__all__ = [
    "LOSS2FN", "PATCH_CONFIG_DOF", "PredictiveViTConfig", "PredictiveViTModel",
    "PredictiveViTTrainingConfig", "patch_mean_bar", "training_loss",
]
