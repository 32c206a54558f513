"""Named model-zoo configs (counterpart of `msvit_tpu/zoo.py`, the same
thirteen names, built as the port's configs):

    from msvit_tpu_torch.zoo import build_config, zoo_names
    cfg = build_config("dino-vitb8")                  # BaseViTConfig
    cfg = build_config("vit-l16", remat=True)         # overrides apply
    cfg = build_config("multistate-sandbox")          # family configs too

Entries are factories (configs are frozen dataclasses: each call returns a
fresh instance); overrides go through `dataclasses.replace`, so an unknown
field name raises.

Trunk geometry: the ViT scales of the ViT/DeiT tables; `dino-vitb8` is
`facebook/dino-vitb8` (ViT-B/8); `dinov2-vitb14` / `dinov2-vitg14` are the
DINOv2 release (LayerScale 1e-5; the giant uses SwiGLU; 518 px, 37 x 37
patches).  The family entries are the reference's sandbox setups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from msvit_tpu_torch.models.base.config import BaseViTConfig


def _base(**kw) -> Callable[[], Any]:
    return lambda: BaseViTConfig(**kw)


def _multistate_sandbox():
    # sandbox/test.py:22,47-57 — dino-vitb8 trunk @224 (784 patch
    # tokens), spectral clustering; periods from configuration_msvit.py
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig

    return MultiStateViTConfig(
        patch_size=8,
        image_size=224,
        pregeneration_period=4,
        generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8,
            num_sample=1024,
            max_clusters=16,
            eigenvalue_threshold=0.1,
            ncut_dist="rbf",
        ),
    )


def _predictive_sandbox():
    # sandbox/predictive.py:48-96 — 64px scaling glimpses, E[context]=2
    from msvit_tpu_torch.models.predictive import PredictiveViTConfig

    return PredictiveViTConfig(
        use_cls_token=False,
        patch_config="scaling",
        default_patch_scale=0.4,
        patch_config_scale=((1.0, 0.0), (1.0, 0.0), (1.0, -1.0)),
        patch_size=64,
        expected_context_length=2.0,
        max_context_length=6,
    )


def _saccadic_reference():
    # configuration_scvit.py:91-114 — 448px images, 128px glimpses,
    # 2x1024 patterns, rank-64 covariances, beam 64 (all config defaults
    # here mirror those values already)
    from msvit_tpu_torch.models.saccadic import SaccadicViTConfig

    return SaccadicViTConfig()


def _subsample_sandbox():
    # sandbox/subsample_vit.py:52-90 — 6 layers, grid 4 -> x2, depth 1
    from msvit_tpu_torch.models.subsample import SubsampleViTConfig

    return SubsampleViTConfig(
        num_hidden_layers=6,
        image_size=224,
        patch_size=14,
        initial_grid_size=4,
        multiplicative_grid_size=2,
        nesting_mode="open",
        max_depth=1,
        num_labels=1000,
    )


_ZOO: Dict[str, Callable[[], Any]] = {
    # --- base trunks ---
    "vit-t16": _base(hidden_size=192, num_attention_heads=3),
    "vit-s16": _base(hidden_size=384, num_attention_heads=6),
    "vit-b16": _base(),
    "vit-b8": _base(patch_size=8),
    "vit-l16": _base(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16
    ),
    "vit-h14": _base(
        hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
        patch_size=14,
    ),
    # the reference's eval trunk (sandbox/test.py:22)
    "dino-vitb8": _base(patch_size=8),
    "dinov2-vitb14": _base(
        patch_size=14, image_size=518, layerscale_value=1e-5
    ),
    "dinov2-vitg14": _base(
        hidden_size=1536, num_hidden_layers=40, num_attention_heads=24,
        patch_size=14, image_size=518, layerscale_value=1e-5,
        use_swiglu_ffn=True,
    ),
    # --- family setups (reference sandbox / config scale) ---
    "multistate-sandbox": _multistate_sandbox,
    "predictive-sandbox": _predictive_sandbox,
    "saccadic-reference": _saccadic_reference,
    "subsample-sandbox": _subsample_sandbox,
}


def zoo_names():
    """Registered names, stable order."""
    return tuple(_ZOO)


def build_config(name: str, **overrides):
    """Build the named config; keyword overrides replace fields
    (unknown fields raise, via dataclasses.replace)."""
    try:
        factory = _ZOO[name]
    except KeyError:
        raise KeyError(
            f"unknown zoo config {name!r}; available: {', '.join(_ZOO)}"
        ) from None
    cfg = factory()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
