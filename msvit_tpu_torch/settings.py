"""Dtype policy for the PyTorch port (counterpart of `msvit_tpu/settings.py`).

Nothing happens at import.  ``Policy`` keeps dtype *names* so configs stay
hashable and comparable with the JAX package's; the properties resolve them
to torch dtypes at use.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy.

    param_dtype:   dtype parameters are stored in (f32 master copies).
    compute_dtype: dtype matmuls run in (bf16 on the tensor cores).
    output_dtype:  dtype activations are returned in.
    """

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    output_dtype: str = "bfloat16"

    @property
    def param(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def compute(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def output(self) -> torch.dtype:
        return _DTYPES[self.output_dtype]


def default_policy() -> Policy:
    """bf16 compute / f32 params — the serving policy."""
    return Policy()


def parity_policy() -> Policy:
    """Full float32 — used for numerical parity against the JAX package
    (the repo's bar: <=1e-3 max abs deviation)."""
    return Policy("float32", "float32", "float32")
