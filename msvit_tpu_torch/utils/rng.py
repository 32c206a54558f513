"""Explicit random streams (the port's counterpart of `jax.random` keys).

A JAX key is split or folded and handed down; here an integer seed is
folded (`fold_in`) and seeds a `torch.Generator` where numbers are drawn.
Seeds are plain ints, so a recomputation (remat) or a resumed run that is
given the same seed draws the same numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_U64 = 2**64


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed mixed from `seed` and `data` (numpy's SeedSequence):
    the counterpart of `jax.random.fold_in(key, data)`."""
    words = np.random.SeedSequence([seed % _U64, *(d % _U64 for d in data)])
    hi, lo = words.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 62-bit seed drawn from `generator` (the default CPU generator
    when None).  A CPU generator costs no device sync."""
    device = "cpu" if generator is None else generator.device
    return int(torch.randint(0, 2**62, (1,), generator=generator, device=device))
