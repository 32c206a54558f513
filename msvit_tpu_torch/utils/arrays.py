"""Host helpers over numpy object arrays and namespaces (the port's copy of
`msvit_tpu/utils/arrays.py`): `multi_*` comprehension over any-dtype
ndarrays, `PTR`, `print_disabled`, `array_of`, `nested_vars`,
`nested_type`, `map_dict` and `call_func_with_kwargs`.  Experiment
bookkeeping on the host, not device data.
"""

from __future__ import annotations

import os
import sys
from argparse import Namespace
from typing import Any, Callable, Dict, Iterable, Sequence, Tuple, TypeVar

import numpy as np

_T = TypeVar("_T")


def multi_iter(arr: np.ndarray) -> Iterable[Any]:
    """Flat iteration over any-dtype ndarrays."""
    for x in np.nditer(arr, flags=["refs_ok"]):
        yield x[()]


def multi_enumerate(arr: np.ndarray) -> Iterable[Tuple[Sequence[int], Any]]:
    it = np.nditer(arr, flags=["multi_index", "refs_ok"])
    for x in it:
        yield it.multi_index, x[()]


def multi_map(
    func: Callable[[Any], Any], arr: np.ndarray, dtype: type = None
) -> np.ndarray:
    if dtype is None:
        dtype = type(func(arr.ravel()[0]))
    result = np.empty_like(arr, dtype=dtype)
    for idx, x in multi_enumerate(arr):
        result[idx] = func(x)
    return result


def multi_zip(*arrs: np.ndarray) -> np.recarray:
    result = np.recarray(
        arrs[0].shape, dtype=[(f"f{i}", arr.dtype) for i, arr in enumerate(arrs)]
    )
    for i, arr in enumerate(arrs):
        setattr(result, f"f{i}", arr)
    return result


def array_of(o: _T) -> np.ndarray:
    """Box any object into a 0-d object ndarray."""
    m = np.array(None, dtype=object)
    m[()] = o
    return m


class PTR:
    """Single-object box."""

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __iter__(self):
        yield self.obj


class print_disabled:
    """Stdout suppressor context."""

    def __enter__(self):
        self._original_stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._original_stdout


def nested_vars(n: Namespace) -> Dict[str, Any]:
    """Flatten nested argparse Namespaces."""
    result: Dict[str, Any] = {}

    def rec(prefix: Tuple[str, ...], ns: Namespace) -> None:
        for k, v in vars(ns).items():
            if isinstance(v, Namespace):
                rec((*prefix, k), v)
            else:
                result[".".join((*prefix, k))] = v

    rec((), n)
    return result


def nested_type(o: Any) -> Any:
    if type(o) in (list, tuple):
        return type(o)(map(nested_type, o))
    if type(o) is dict:
        return {k: nested_type(v) for k, v in o.items()}
    return type(o)


def map_dict(d: Dict[str, Any], func: Callable[[Any], Any]) -> Dict[str, Any]:
    return {
        k: map_dict(v, func) if hasattr(v, "items") else func(v)
        for k, v in d.items()
    }


def call_func_with_kwargs(
    func: Callable, args: Tuple[Any, ...] = (), kwargs: Dict[str, Any] = None
):
    """Call func, dropping the kwargs its signature does not take."""
    import inspect

    kwargs = dict(kwargs or {})
    try:
        params = inspect.signature(func).parameters
        if not any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        ):
            kwargs = {k: v for k, v in kwargs.items() if k in params}
    except (TypeError, ValueError):
        pass
    return func(*args, **kwargs)
