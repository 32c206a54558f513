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
    # cluster-banded attention (K10): not ported, raises at build
    banded_attention: bool = False

    @property
    def max_clusters(self) -> int:
        """Static padded cluster-axis size."""
        return self.clustering.max_clusters

    def check_supported(self) -> None:
        super().check_supported()
        if self.banded_attention:
            raise NotImplementedError(
                "not ported yet: banded_attention=True needs K10 "
                "(ops/banded_attention.py `_token_rows_banded`; ROADMAP.md "
                "queue 2)")
        check_clustering(self.clustering)
