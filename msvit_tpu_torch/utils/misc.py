"""Timers and model size (counterpart of `msvit_tpu/utils/misc.py`)."""

from __future__ import annotations

import time
from typing import Any, Mapping, Union

import torch
from torch import nn


class Timer:
    """perf_counter stopwatch, also a context manager (``.duration`` on
    exit).  Card work runs asynchronously: synchronise before `.elapsed()`
    or the exit when timing it."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def __enter__(self) -> "Timer":
        self.reset()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.duration = self.elapsed()


def model_size(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Parameter count of a module (its parameters) or of a state dict
    (every tensor in it)."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return int(sum(t.numel() for t in tensors))
