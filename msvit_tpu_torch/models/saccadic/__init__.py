"""Saccadic encoder: serial foveated saccades over an image, matching
learned Gaussian patterns by beam search, with a transformer refiner
(counterpart of `msvit_tpu/models/saccadic/`)."""

from msvit_tpu_torch.models.saccadic.batched import batched_saccade_run
from msvit_tpu_torch.models.saccadic.config import PATCH_CONFIG_DOF, SaccadicViTConfig
from msvit_tpu_torch.models.saccadic.embeddings import (
    SaccadicViTEmbeddings,
    SaccadicViTPatchEmbeddings,
)
from msvit_tpu_torch.models.saccadic.losses import (
    pattern_nll_loss,
    refiner_preservation_loss,
    trace_losses,
)
from msvit_tpu_torch.models.saccadic.model import Edge, SaccadicViTModel
from msvit_tpu_torch.models.saccadic.pattern import (
    SaccadicViTMultiStatePattern,
    gaussian_low_rank_log_pdf,
    gaussian_low_rank_log_pdf_chol,
)
from msvit_tpu_torch.models.saccadic.refiner import (
    EagerSelfAttention,
    QuadraticSelfAttention,
    SaccadicViTEncoder,
    SaccadicViTLayer,
    TransformerSaccadicViTPredictor,
)

__all__ = [
    "EagerSelfAttention", "Edge", "PATCH_CONFIG_DOF", "QuadraticSelfAttention",
    "SaccadicViTConfig", "SaccadicViTEmbeddings", "SaccadicViTEncoder", "SaccadicViTLayer",
    "SaccadicViTModel", "SaccadicViTMultiStatePattern", "SaccadicViTPatchEmbeddings",
    "TransformerSaccadicViTPredictor", "batched_saccade_run", "gaussian_low_rank_log_pdf",
    "gaussian_low_rank_log_pdf_chol", "pattern_nll_loss", "refiner_preservation_loss",
    "trace_losses",
]
