"""Weight conversion from the JAX package, and the import of HF
ViT / DINO / DINOv2 checkpoints into every family."""

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
from msvit_tpu_torch.compat.family_import import (
    import_into_multistate,
    import_into_predictive,
    import_into_subsample,
)
from msvit_tpu_torch.compat.hf_import import import_vit_params, load_torch_state_dict
from msvit_tpu_torch.compat.pretrained import (
    config_from_hf,
    load_pretrained_vit,
    load_state_dict_from,
    resolve_checkpoint,
)

__all__ = ["act_scales_from_jax", "classifier_params_from_jax", "config_from_hf",
           "import_into_multistate", "import_into_predictive", "import_into_subsample",
           "import_vit_params", "load_pretrained_vit", "load_state_dict_from",
           "load_torch_state_dict", "resolve_checkpoint",
           "multistate_classifier_params_from_jax", "multistate_params_from_jax",
           "predictive_params_from_jax", "saccadic_params_from_jax",
           "subsample_classifier_params_from_jax", "subsample_params_from_jax",
           "transfer_base_to_multistate", "transfer_base_to_subsample",
           "vit_params_from_jax"]
