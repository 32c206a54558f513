"""Nested-container and config helpers (counterpart of
`msvit_tpu/utils/tree.py`)."""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Mapping, Sequence

import torch


def stack_pytrees(trees: Sequence[Any]) -> Any:
    """Stack identically structured nested dicts / lists / tuples of
    tensors along a new leading axis (the counterpart of
    `jax.tree.map(jnp.stack, *trees)`; `torch.func.functional_call` under
    `torch.vmap` then runs a stack of models)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: stack_pytrees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_pytrees(list(xs)) for xs in zip(*trees))
    return torch.stack([torch.as_tensor(t) for t in trees])


def flatten_nested_dict(d: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
    """Flatten nested dicts into `sep`-joined keys."""
    out: Dict[str, Any] = {}

    def rec(prefix: str, value: Any) -> None:
        if isinstance(value, Mapping):
            for k, v in value.items():
                rec(f"{prefix}{sep}{k}" if prefix else str(k), v)
        else:
            out[prefix] = value

    rec("", d)
    return out


def _jsonable(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _jsonable(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "__dict__") and not isinstance(value, type):
        return _jsonable(vars(value))
    return value


def hash_config(config: Any) -> str:
    """Deterministic sha256 of a config object (experiment identity)."""
    payload = json.dumps(_jsonable(config), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()
