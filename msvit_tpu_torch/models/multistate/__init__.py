"""Multi-state encoder: mid-network token clustering with cluster-restricted
attention mediated by learned transmitter/receiver tokens (counterpart of
`msvit_tpu/models/multistate/`)."""

from msvit_tpu_torch.models.multistate.config import MultiStateViTConfig
from msvit_tpu_torch.models.multistate.model import (
    MultiStateViTEncoderBackbone,
    MultiStateViTEncoderModel,
    MultiStateViTForImageClassification,
    build_multistate_attention_mask,
)
from msvit_tpu_torch.models.multistate.quantized import (
    calibrate_multistate_act_scales,
    quantize_multistate_params,
    quantized_multistate_apply,
)

__all__ = [
    "MultiStateViTConfig", "MultiStateViTEncoderBackbone",
    "MultiStateViTEncoderModel", "MultiStateViTForImageClassification",
    "build_multistate_attention_mask",
    "calibrate_multistate_act_scales", "quantize_multistate_params",
    "quantized_multistate_apply",
]
