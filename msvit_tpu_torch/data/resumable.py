"""Deterministic, checkpointable input iteration (counterpart of
`msvit_tpu/data/resumable.py`; pure numpy, so every epoch order equals the
JAX package's element for element).

New capability relative to the reference (SURVEY §5: its sandbox loops
restart data from scratch; there is no persistence of any kind) —
production training needs exact mid-epoch resume: after a preemption the
restored run must see the SAME example sequence as an uninterrupted run.

Design (grain-style index sampling, not iterator pickling):

* `IndexSampler` — the epoch order is a **bijective index shuffle**
  computed on the fly (a 4-round Feistel network over the example-index
  domain with cycle-walking), so the resume state is four integers no
  matter the dataset size and any epoch's order is recomputable from
  (seed, epoch) alone.  Sharding for data-parallel hosts is a strided
  slice of the same global order (every host derives its stream from
  identical state).
* `ResumableLoader` — sampler + `fetch_fn(indices) -> batch dict`.  The
  sampler state *rides each batch* through the background prefetch
  thread (`data/pipeline.py::prefetch_to_device` passes a dict of ints
  through untouched), so `state_dict()` always reflects what the consumer
  actually received — a naive "ask the sampler" would over-advance by the
  prefetch buffer depth.
* `train.Trainer` saves this state next to the model and optimizer state
  in its checkpoint (from any iterator with `state_dict`), and
  `Trainer.restore(data_iter)` loads it back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, modular uint64)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _MIX1
    x ^= x >> np.uint64(27)
    x *= _MIX2
    x ^= x >> np.uint64(31)
    return x


def feistel_permutation(
    idx: np.ndarray, n: int, key: int, rounds: int = 4
) -> np.ndarray:
    """Map positions -> shuffled example ids: a keyed bijection on [0, n)
    (balanced Feistel over the next even-bit power-of-two domain, with
    cycle-walking back into range).  O(1) memory; vectorized."""
    if n <= 1:
        return np.zeros_like(np.asarray(idx, np.int64))
    half = max(1, (int(n - 1).bit_length() + 1) // 2)
    mask = np.uint64((1 << half) - 1)
    sh = np.uint64(half)
    kk = np.uint64(key & 0xFFFFFFFFFFFFFFFF)

    round_keys = [
        np.uint64((int(kk) + (rnd + 1) * int(_GOLDEN)) & 0xFFFFFFFFFFFFFFFF)
        for rnd in range(rounds)
    ]

    def enc(v: np.ndarray) -> np.ndarray:
        l, r = v >> sh, v & mask
        for rk in round_keys:
            f = _mix64(r + rk)
            l, r = r, (l ^ f) & mask
        return (l << sh) | r

    out = np.asarray(idx, np.uint64)
    out = enc(out)
    oob = out >= np.uint64(n)
    while oob.any():  # cycle-walk: re-encrypt only out-of-range values
        out = np.where(oob, enc(out), out)
        oob = out >= np.uint64(n)
    return out.astype(np.int64)


@dataclasses.dataclass
class IndexSampler:
    """Deterministic batch-index stream with O(1) checkpoint state.

    Yields int64 arrays of example indices.  `shard_index/shard_count`
    give each data-parallel host a disjoint strided slice of the same
    global per-epoch order.  With `drop_remainder` every epoch has
    exactly `num_examples // (batch_size * shard_count)` batches per
    shard (the tail is dropped: every batch has one shape).
    """

    num_examples: int
    batch_size: int
    seed: int = 0
    shuffle: bool = True
    shard_index: int = 0
    shard_count: int = 1
    num_epochs: Optional[int] = None  # None = loop forever
    # --- resume state ---
    epoch: int = 0
    pos: int = 0  # batches already emitted this epoch (this shard)

    def __post_init__(self):
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError("shard_index out of range")
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"num_examples={self.num_examples} too small for "
                f"batch_size={self.batch_size} x shard_count={self.shard_count}"
            )

    @property
    def batches_per_epoch(self) -> int:
        return self.num_examples // (self.batch_size * self.shard_count)

    def _epoch_key(self, epoch: int) -> int:
        return int(_mix64(np.asarray([self.seed], np.uint64) * _GOLDEN
                          + np.uint64(epoch))[0])

    def _batch_indices(self, epoch: int, pos: int) -> np.ndarray:
        # global positions of this shard's pos-th batch: strided layout
        # [shard 0 batch, shard 1 batch, ...] so shards stay disjoint.
        start = (pos * self.shard_count + self.shard_index) * self.batch_size
        positions = np.arange(start, start + self.batch_size, dtype=np.int64)
        if not self.shuffle:
            return positions
        return feistel_permutation(
            positions, self.num_examples, self._epoch_key(epoch)
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.num_epochs is None or self.epoch < self.num_epochs:
            while self.pos < self.batches_per_epoch:
                batch = self._batch_indices(self.epoch, self.pos)
                self.pos += 1
                yield batch
            self.epoch += 1
            self.pos = 0

    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": int(self.epoch),
            "pos": int(self.pos),
            "seed": int(self.seed),
            "num_examples": int(self.num_examples),
            "batch_size": int(self.batch_size),
            "shard_count": int(self.shard_count),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for field in ("seed", "num_examples", "batch_size", "shard_count"):
            if field in state and int(state[field]) != getattr(self, field):
                raise ValueError(
                    f"checkpointed sampler {field}={int(state[field])} != "
                    f"current {getattr(self, field)} — resuming with a "
                    "different data configuration is not deterministic"
                )
        self.epoch = int(state["epoch"])
        self.pos = int(state["pos"])


_STATE_KEY = "_loader_state"


class ResumableLoader:
    """Checkpointable batch loader: `fetch_fn(indices) -> dict batch`.

    `state_dict()` is exact under prefetching: each batch carries the
    sampler state that resumes *after* it, and the property reflects the
    last batch handed to the consumer, not the prefetch thread's cursor.
    """

    def __init__(
        self,
        sampler: IndexSampler,
        fetch_fn: Callable[[np.ndarray], Dict[str, Any]],
        prefetch: int = 0,
        transform=None,
        device=None,
    ):
        """`prefetch > 0` sends batches to `device` (default: the CUDA card)
        through `prefetch_to_device`, `transform` applied on the device."""
        self.sampler = sampler
        self.fetch_fn = fetch_fn
        self.prefetch = prefetch
        self.transform = transform
        self.device = device
        self._state = sampler.state_dict()
        self._stream: Optional[Iterator] = None

    def _gen(self) -> Iterator[dict]:
        for idx in self.sampler:
            batch = dict(self.fetch_fn(idx))
            batch[_STATE_KEY] = self.sampler.state_dict()
            yield batch

    def __iter__(self) -> "ResumableLoader":
        return self

    def __next__(self) -> dict:
        if self._stream is None:
            inner = self._gen()
            if self.prefetch > 0:
                from msvit_tpu_torch.data.pipeline import prefetch_to_device

                inner = prefetch_to_device(
                    inner,
                    buffer_size=self.prefetch,
                    device=self.device,
                    transform=self.transform,
                )
            self._stream = inner
        batch = next(self._stream)
        self._state = batch.pop(_STATE_KEY)
        return batch

    def state_dict(self) -> Dict[str, int]:
        return dict(self._state)

    def close(self) -> None:
        """Stop the prefetch thread (the JAX package leaves it to garbage
        collection; here it also holds pinned host buffers)."""
        if self._stream is not None:
            self._stream.close()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self._stream is not None:
            raise RuntimeError("load_state_dict before consuming batches")
        self.sampler.load_state_dict(state)
        self._state = self.sampler.state_dict()
