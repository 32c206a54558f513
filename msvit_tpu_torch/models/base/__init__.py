"""Base ViT trunk, standard ViT front end and the int8 serving path."""

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.vit import ViTForImageClassification, ViTModel

__all__ = ["BaseViTConfig", "ViTForImageClassification", "ViTModel"]
