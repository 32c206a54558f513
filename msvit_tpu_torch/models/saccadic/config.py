"""Saccadic config (counterpart of `msvit_tpu/models/saccadic/config.py`,
field for field and default for default)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from msvit_tpu_torch.models.base.config import BaseViTConfig

PATCH_CONFIG_DOF = {
    "translation": 2,
    "scaling": 3,
    "non-uniform-scaling": 4,
}


@dataclasses.dataclass(frozen=True)
class SaccadicViTConfig(BaseViTConfig):
    # ((complexity, num_patterns), ...)
    num_patterns: Tuple[Tuple[int, int], ...] = ((1, 1024), (2, 1024))
    covariance_dim: int = 64  # low-rank covariance factor width
    log_covariance_shift: float = 0.0
    beam_size: int = 64
    # matcher decomposition: "chol" (Cholesky-Woodbury) or "eigh" (the
    # factor's Gram eigendecomposition); equal log-pdfs and conditional means
    matcher_solver: str = "chol"
    refiner_implementation: str = "transformer"
    # refiner attention: "eager" (MHSA) or "quadratic"
    # (QK^T - 1/2 |dist(q) - dist(k)|^2)
    refiner_attention: str = "quadratic"

    image_size: int = 448
    patch_size: int = 128  # glimpse resolution
    patch_config: str = "translation"
    pe_bias: bool = True

    @property
    def dof(self) -> int:
        return PATCH_CONFIG_DOF[self.patch_config]

    @property
    def num_patterns_dict(self):
        return dict(self.num_patterns)

    @property
    def max_complexity(self) -> int:
        return max(k for k, _ in self.num_patterns)
