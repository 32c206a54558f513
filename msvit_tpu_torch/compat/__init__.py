"""Weight conversion from the JAX package."""

from msvit_tpu_torch.compat.from_jax import (
    act_scales_from_jax,
    classifier_params_from_jax,
    multistate_classifier_params_from_jax,
    multistate_params_from_jax,
    predictive_params_from_jax,
    saccadic_params_from_jax,
    subsample_classifier_params_from_jax,
    subsample_params_from_jax,
    vit_params_from_jax,
)
from msvit_tpu_torch.compat.family import (
    transfer_base_to_multistate,
    transfer_base_to_subsample,
)

__all__ = ["act_scales_from_jax", "classifier_params_from_jax",
           "multistate_classifier_params_from_jax", "multistate_params_from_jax",
           "predictive_params_from_jax", "saccadic_params_from_jax",
           "subsample_classifier_params_from_jax", "subsample_params_from_jax",
           "transfer_base_to_multistate", "transfer_base_to_subsample",
           "vit_params_from_jax"]
