"""Subsample encoder: coarse-to-fine quadtree token refinement with a
REINFORCE-trained binary subdivision policy (counterpart of
`msvit_tpu/models/subsample/`)."""

from msvit_tpu_torch.models.subsample.config import SubsampleViTConfig
from msvit_tpu_torch.models.subsample.model import (
    QuadTree,
    SubsampleViTEmbeddings,
    SubsampleViTForImageClassification,
    SubsampleViTModel,
    build_quadtree,
    reinforce_loss,
    subdivide_boxes,
)

__all__ = [
    "QuadTree", "SubsampleViTConfig", "SubsampleViTEmbeddings",
    "SubsampleViTForImageClassification", "SubsampleViTModel", "build_quadtree",
    "reinforce_loss", "subdivide_boxes",
]
