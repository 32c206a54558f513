"""Utilities of the port: explicit random streams (`rng`), metrics logging
(`metrics`), math helpers, nested-container helpers, timers and tracing
(counterpart of `msvit_tpu/utils`)."""

from msvit_tpu_torch.utils.math import (  # noqa: F401
    batch_trace,
    ceildiv,
    gaussian_kl,
    hadamard_conjugation,
    hadamard_conjugation_diff_order1,
    hadamard_conjugation_diff_order2,
    inverse_cubic,
    multiclass_logits,
    pow_series,
    sqrtm,
)
from msvit_tpu_torch.utils.misc import Timer, model_size  # noqa: F401
from msvit_tpu_torch.utils.tree import (  # noqa: F401
    flatten_nested_dict,
    hash_config,
    stack_pytrees,
)
