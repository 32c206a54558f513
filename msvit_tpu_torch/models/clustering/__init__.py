"""Token clustering used by the multistate encoder (counterpart of
`msvit_tpu/models/clustering/`).

    cluster(config, parent_indices [B, N], x [B, N, D], key)
        -> (child_indices [B, N], n_children [C_max] or [B, C_max])

Child ids are contiguous in parent order, so
`parent_of(child) = searchsorted(cumsum(n_children), child, right=True)`.
"""

from msvit_tpu_torch.models.clustering.module import (
    AxisAlignClusteringConfig,
    ClusteringConfig,
    FPSClusteringConfig,
    SpectralClusteringConfig,
    check_supported,
    cluster,
    max_children_bound,
    spectral_cluster,
)

__all__ = [
    "AxisAlignClusteringConfig", "ClusteringConfig", "FPSClusteringConfig",
    "SpectralClusteringConfig", "check_supported", "cluster",
    "max_children_bound", "spectral_cluster",
]
