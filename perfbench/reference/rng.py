"""Counter-based random streams, frozen for the reference.

A copy of the draws the program makes for clustering: a stream is a
63-bit seed, `split(n)` gives children seeded by numpy's SeedSequence of
(seed, i), and a draw hashes each element's flat index with two 32-bit
words of the stream.  The reference needs the same numbers as the program
to reproduce its partition from the seed, so this file changes only if
the program's streams change, and then as a new reference.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

_U64 = 2**64
_M32 = 0xFFFFFFFF


def fold_in(seed: int, *data: int) -> int:
    words = np.random.SeedSequence([seed % _U64, *(d % _U64 for d in data)])
    hi, lo = words.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    return x ^ (x >> 16)


def _bits(words: torch.Tensor, shape: Sequence[int], device) -> torch.Tensor:
    """24 random bits per element: [*L, *shape] for words [*L, 2]."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    k0, k1 = words[..., :1], words[..., 1:2]
    return (_mix32(_mix32(i ^ k0) ^ k1) >> 8).reshape(*words.shape[:-1], *shape)


class Stream:
    """One random stream (the program's `Rng`)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def words(self) -> tuple:
        state = np.random.SeedSequence(self.seed % _U64).generate_state(4, np.uint32)
        return tuple(int(w) for w in state)

    def split(self, n: int) -> List["Stream"]:
        return [Stream(fold_in(self.seed, i)) for i in range(n)]


def words_of(streams: Sequence[Stream], device) -> torch.Tensor:
    """[C, 4] int64 key words."""
    return torch.tensor([s.words() for s in streams], dtype=torch.int64, device=device)


def uniform(words: torch.Tensor, shape, lo: float, hi: float, device) -> torch.Tensor:
    u = _bits(words[..., :2], shape, device).to(torch.float32) * 2.0**-24
    return u * (hi - lo) + lo


def normal(words: torch.Tensor, shape, device) -> torch.Tensor:
    """Box-Muller on two 24-bit uniforms."""
    u1 = (_bits(words[..., :2], shape, device) + 1).to(torch.float32) * 2.0**-24
    u2 = _bits(words[..., 2:], shape, device).to(torch.float32) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
