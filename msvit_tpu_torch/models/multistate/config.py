"""Multistate config (counterpart of `msvit_tpu/models/multistate/config.py`,
field for field)."""

from __future__ import annotations

import dataclasses

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.clustering import (
    ClusteringConfig,
    SpectralClusteringConfig,
    check_supported as check_clustering,
)


@dataclasses.dataclass(frozen=True)
class MultiStateViTConfig(BaseViTConfig):
    # layers before the first clustering event
    pregeneration_period: int = 4
    # layers between re-clusterings
    generation_period: int = 2
    # soft mask penalty: scores - inf * (1 - mask)
    attention_mask_inf: float = 1e2
    clustering: ClusteringConfig = SpectralClusteringConfig()
    # cluster-banded attention: tokens kept sorted by cluster id, the trunk
    # layers' attention `ops/banded_attention.py` (K10), no [S, S] mask
    banded_attention: bool = False

    @property
    def max_clusters(self) -> int:
        """Static padded cluster-axis size."""
        return self.clustering.max_clusters

    def check_supported(self) -> None:
        super().check_supported()
        check_clustering(self.clustering)
