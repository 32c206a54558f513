"""Explicit random streams (the port's counterpart of `jax.random` keys).

A JAX key is split or folded and handed down; here an integer seed is
folded (`fold_in`) and keys a counter-based draw where numbers are drawn.
Seeds are plain ints, so a recomputation (remat) or a resumed run that is
given the same seed draws the same numbers.

`Rng` is a node of a key tree: code written against JAX keys takes an
`Rng` where JAX takes a key and calls `split` and the draws in JAX's
order.  Any object with the same three methods serves (the tests hand the
port an adapter over `jax.random`, so that both packages draw the same
numbers).

A draw is a hash of (seed, element index) in integer tensor ops
(`_bits`): no generator state, so it traces at a symbolic size (an
exported forward whose batch axis is symbolic draws B x N numbers), a
traced graph draws what an eager call draws, and the integer bits are the
same on every device.  Element i of a draw does not depend on the draw's
size: the first rows of a larger batch draw what a smaller one draws.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

_U64 = 2**64
_M32 = 0xFFFFFFFF


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


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply, lowbias32's shape) of
    int64 values in [0, 2^32); both multipliers are below 2^31, so no
    product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    return x ^ (x >> 16)


def _bits(words, shape: Sequence[int], device) -> torch.Tensor:
    """24 random bits per element, int64 of `shape` (or [C, *shape] for a
    [C, 2] tensor of key words): the element's flat index hashed with the
    stream's two 32-bit words."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(words, torch.Tensor):
        k0, k1 = words[:, :1], words[:, 1:]
        shape = (words.shape[0], *shape)
    else:
        k0, k1 = words
    return (_mix32(_mix32(i ^ k0) ^ k1) >> 8).reshape(tuple(shape))


def _uniform(words, shape, lo: float, hi: float, device) -> torch.Tensor:
    u = _bits(words, shape, device).to(torch.float32) * 2.0**-24  # [0, 1 - 2^-24]
    return u * (hi - lo) + lo


def _normal(words, shape, device) -> torch.Tensor:
    """Box-Muller on two 24-bit uniforms (the second pair of words)."""
    if isinstance(words, torch.Tensor):
        w1, w2 = words[:, :2], words[:, 2:]
    else:
        w1, w2 = words[:2], words[2:]
    u1 = (_bits(w1, shape, device) + 1).to(torch.float32) * 2.0**-24  # (0, 1]
    u2 = _bits(w2, shape, device).to(torch.float32) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


class Rng:
    """A random stream: `split(n)` gives `n` children seeded with
    `fold_in(seed, i)` (JAX's `random.split`); each draw hashes the element
    index with words derived from `seed` (module docstring), so a stream
    draws the same numbers every time it is asked (as a JAX key does), on
    any device.  Costs no device sync."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._words = None

    def words(self) -> tuple:
        """Four 32-bit key words of the stream (SeedSequence of the seed)."""
        if self._words is None:
            state = np.random.SeedSequence(self.seed % _U64).generate_state(4, np.uint32)
            self._words = tuple(int(w) for w in state)
        return self._words

    def split(self, n: int) -> List["Rng"]:
        return [Rng(fold_in(self.seed, i)) for i in range(n)]

    def uniform(self, shape: Sequence[int], lo: float, hi: float,
                device) -> torch.Tensor:
        """f32 uniform on [lo, hi) (24 random bits)."""
        return _uniform(self.words()[:2], shape, lo, hi, device)

    def normal(self, shape: Sequence[int], device) -> torch.Tensor:
        """f32 standard normal."""
        return _normal(self.words(), shape, device)


def _key_words(keys: Sequence, device) -> Optional[torch.Tensor]:
    """[C, 4] int64 key words of `keys` if every one is an `Rng`, else None."""
    if not all(isinstance(k, Rng) for k in keys):
        return None
    return torch.tensor([k.words() for k in keys], dtype=torch.int64, device=device)


def uniform_rows(keys: Sequence, shape: Sequence[int], lo: float, hi: float,
                 device) -> torch.Tensor:
    """[C, *shape]: row c is `keys[c].uniform(shape, lo, hi, device)`, drawn
    in one pass where every key is an `Rng` (any other stream object, such
    as an adapter over `jax.random`, draws row by row)."""
    words = _key_words(keys, device)
    if words is None:
        return torch.stack([k.uniform(shape, lo, hi, device) for k in keys])
    return _uniform(words[:, :2], shape, lo, hi, device)


def normal_rows(keys: Sequence, shape: Sequence[int], device) -> torch.Tensor:
    """[C, *shape]: row c is `keys[c].normal(shape, device)` (as
    `uniform_rows`)."""
    words = _key_words(keys, device)
    if words is None:
        return torch.stack([k.normal(shape, device) for k in keys])
    return _normal(words, shape, device)
