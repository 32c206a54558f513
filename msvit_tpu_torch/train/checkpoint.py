"""Checkpoint / resume (counterpart of `msvit_tpu/train/checkpoint.py`).

A checkpoint is one `torch.save` file per step, ``<dir>/ckpt_<step>.pt``,
holding a nested dict of tensors and plain values (model and optimizer
state dicts, the step, the EMA, the data iterator's position).  It is
written to a temporary name and renamed into place, so a reader never sees
a partial file.  Loading uses `torch.load(weights_only=True)`.

A sharded state (every rank holding its part, e.g. FSDP's `DTensor`s or
`parallel.sharding.sharded_state_dict`) is saved by all ranks together with
`torch.distributed.checkpoint` under ``<dir>/sharded_<step>/``
(`save_sharded_checkpoint`), and restored into a state of any layout, the
target's own (`restore_sharded_checkpoint`): FSDP-sharded parameters restore
onto plain replicated tensors, a tp=2 state onto tp=4.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_SHARDED = re.compile(r"^sharded_(\d+)$")


def _path(directory: str) -> Path:
    return Path(os.path.abspath(os.path.expanduser(directory)))


def _to_host(obj: Any) -> Any:
    """A host copy of every tensor in a nested dict / list / tuple: copies,
    so that later in-place updates of the live state do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def steps(directory: str) -> List[int]:
    """The steps saved under `directory`, ascending."""
    d = _path(directory)
    if not d.is_dir():
        return []
    found = (_NAME.match(p.name) for p in d.iterdir())
    return sorted(int(m.group(1)) for m in found if m)


def _write(directory: Path, step: int, host_state: Any) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"ckpt_{step}.pt"
    tmp = directory / f".ckpt_{step}.pt.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(host_state, tmp)
    os.replace(tmp, final)


def save_checkpoint(directory: str, step: int, state: Any) -> None:
    """Save a nested dict of tensors and plain values under directory/step
    (synchronously)."""
    _write(_path(directory), step, _to_host(state))


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location="cpu") -> Any:
    """Load the latest (or the given) step's state."""
    if step is None:
        saved = steps(directory)
        if not saved:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        step = saved[-1]
    return torch.load(_path(directory) / f"ckpt_{step}.pt",
                      map_location=map_location, weights_only=True)


class CheckpointManager:
    """Periodic, asynchronous saves for a training loop, and resume.

    `maybe_save` pays only the device-to-host snapshot of the state (a
    copy, so the next step may update the live tensors at once); the
    serialization and the write run in a background thread.  At most one
    write is in flight: a save first waits for the previous one.  `wait()`
    and `close()` fence the last one and raise its error, if it failed.
    The newest `max_to_keep` checkpoints are kept."""

    def __init__(self, directory: str, save_every: int = 1000,
                 max_to_keep: int = 3):
        self.directory = _path(directory)
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.save_every:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state: Any) -> None:
        self.wait()
        host = _to_host(state)
        self._thread = threading.Thread(
            target=self._run, args=(step, host), name=f"checkpoint-{step}")
        self._thread.start()

    def _run(self, step: int, host_state: Any) -> None:
        try:
            _write(self.directory, step, host_state)
            for old in steps(str(self.directory))[:-self.max_to_keep]:
                (self.directory / f"ckpt_{old}.pt").unlink(missing_ok=True)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Barrier on the in-flight write; raises its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        saved = steps(str(self.directory))
        return saved[-1] if saved else None

    def restore_latest(self, map_location="cpu") -> Tuple[int, Any]:
        """(step, state) of the newest checkpoint, or (0, None)."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return 0, None
        return step, restore_checkpoint(str(self.directory), step, map_location)

    def close(self) -> None:
        self.wait()


def sharded_steps(directory: str) -> List[int]:
    """The steps of sharded checkpoints under `directory`, ascending."""
    d = _path(directory)
    if not d.is_dir():
        return []
    found = (_SHARDED.match(p.name) for p in d.iterdir())
    return sorted(int(m.group(1)) for m in found if m)


def save_sharded_checkpoint(directory: str, step: int, state: Any) -> None:
    """Save a state whose tensors may be sharded over ranks (`DTensor`s;
    plain tensors count as whole on every rank).  Every rank of the default
    group calls it."""
    import torch.distributed.checkpoint as dcp

    dcp.save(state, checkpoint_id=str(_path(directory) / f"sharded_{step}"))


def restore_sharded_checkpoint(directory: str, like: Any, step: Optional[int] = None) -> Any:
    """Load the latest (or the given) sharded step into `like`, in place,
    and return it: each of its tensors receives its own part, whatever
    the layout the state was saved from.  Every rank calls it."""
    import torch.distributed.checkpoint as dcp

    if step is None:
        saved = sharded_steps(directory)
        if not saved:
            raise FileNotFoundError(f"no sharded checkpoint under {directory}")
        step = saved[-1]
    dcp.load(like, checkpoint_id=str(_path(directory) / f"sharded_{step}"))
    return like
