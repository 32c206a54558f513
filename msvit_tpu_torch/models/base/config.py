"""Config for the base ViT trunk (counterpart of
`msvit_tpu/models/base/config.py`, field for field).

Fields this port does not implement yet are kept, so a config moves
between the two packages unchanged; `check_supported` (called when a
model is built) raises `NotImplementedError` for each one that is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from msvit_tpu_torch.settings import Policy

# field -> why the port leaves it out
_NOT_PORTED = {
    "scan_layers": "an XLA compile-time tool; the converter unstacks scanned params "
                   "(README.md, 'Not ported, by decision')",
}


@dataclasses.dataclass(frozen=True)
class BaseViTConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-6
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    qkv_bias: bool = True
    qk_norm: bool = False
    layerscale_value: float = 1.0
    drop_path_rate: float = 0.0
    use_swiglu_ffn: bool = False
    num_experts: int = 0
    moe_impl: str = "dispatch"
    moe_capacity_factor: float = 1.25
    pretrained: Optional[str] = None
    # "auto" | "packed" | "xla" | "fused" | "flash"
    attn_implementation: str = "auto"
    policy: Policy = Policy()
    remat: bool = False
    remat_policy: str = ""
    scan_layers: bool = False
    sequence_sharding: bool = False
    attention_head_size: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.attention_head_size is not None:
            return self.attention_head_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_attention_heads {self.num_attention_heads}"
            )
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_hidden_size(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def swiglu_hidden_size(self) -> int:
        h = int(self.mlp_hidden_size * 2 / 3)
        return (h + 7) // 8 * 8

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def check_supported(self) -> None:
        """Raise `NotImplementedError` naming every field set to a value
        this port does not build, by decision."""
        bad = [f for f in _NOT_PORTED if getattr(self, f)]
        if bad:
            raise NotImplementedError(
                "not ported, by decision: "
                + "; ".join(f"{f}={getattr(self, f)!r} -> {_NOT_PORTED[f]}"
                            for f in bad)
            )
