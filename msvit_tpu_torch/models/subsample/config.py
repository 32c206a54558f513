"""Subsample encoder config (counterpart of
`msvit_tpu/models/subsample/config.py`, field for field and default for
default)."""

from __future__ import annotations

import dataclasses

from msvit_tpu_torch.models.base.config import BaseViTConfig


@dataclasses.dataclass(frozen=True)
class SubsampleViTConfig(BaseViTConfig):
    # G: the image is first tiled into G x G boxes
    initial_grid_size: int = 4
    # a subdivided box splits into (mult_grid) x (mult_grid) children
    multiplicative_grid_size: int = 2
    # "open": every token stays live; "lock": tokens that decline to split
    # leave later decisions; "freeze": locked tokens are not re-encoded
    # either, their cached per-layer states are attention context
    nesting_mode: str = "open"
    # weigh deep tokens down in attention by depth * (-log g)
    use_weighted_tokens: bool = False
    # static refinement depth
    max_depth: int = 1
    num_labels: int = 1000
    problem_type: str = "single_label_classification"

    @property
    def children_per_split(self) -> int:
        return self.multiplicative_grid_size**2

    @property
    def num_roots(self) -> int:
        return self.initial_grid_size**2

    @property
    def capacity(self) -> int:
        """Token slots of a full tree of depth `max_depth`."""
        g = self.children_per_split
        total, level = 0, self.num_roots
        for _ in range(self.max_depth + 1):
            total += level
            level *= g
        return total
