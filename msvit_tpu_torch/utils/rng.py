"""Explicit random streams (the port's counterpart of `jax.random` keys).

A JAX key is split or folded and handed down; here an integer seed is
folded (`fold_in`) and seeds a `torch.Generator` where numbers are drawn.
Seeds are plain ints, so a recomputation (remat) or a resumed run that is
given the same seed draws the same numbers.

`Rng` is a node of a key tree: code written against JAX keys takes an
`Rng` where JAX takes a key and calls `split` and the draws in JAX's
order.  Any object with the same three methods serves (the tests hand the
port an adapter over `jax.random`, so that both packages draw the same
numbers).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


class Rng:
    """A random stream: `split(n)` gives `n` children seeded with
    `fold_in(seed, i)` (JAX's `random.split`); each draw comes from a
    `torch.Generator` seeded with `seed` on the target device, so a stream
    draws the same numbers every time it is asked (as a JAX key does).
    Seeding costs no device sync."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def split(self, n: int) -> List["Rng"]:
        return [Rng(fold_in(self.seed, i)) for i in range(n)]

    def _gen(self, device) -> torch.Generator:
        return torch.Generator(device=torch.device(device)).manual_seed(self.seed)

    def uniform(self, shape: Sequence[int], lo: float, hi: float,
                device) -> torch.Tensor:
        """f32 uniform on [lo, hi)."""
        u = torch.rand(tuple(shape), generator=self._gen(device), device=device)
        return u * (hi - lo) + lo

    def normal(self, shape: Sequence[int], device) -> torch.Tensor:
        """f32 standard normal."""
        return torch.randn(tuple(shape), generator=self._gen(device), device=device)
