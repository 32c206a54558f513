"""Weight conversion from the JAX package."""

from msvit_tpu_torch.compat.from_jax import (
    act_scales_from_jax,
    classifier_params_from_jax,
    multistate_classifier_params_from_jax,
    multistate_params_from_jax,
    vit_params_from_jax,
)

__all__ = ["act_scales_from_jax", "classifier_params_from_jax",
           "multistate_classifier_params_from_jax", "multistate_params_from_jax",
           "vit_params_from_jax"]
