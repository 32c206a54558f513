"""Metrics logging (counterpart of `msvit_tpu/utils/metrics.py`)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    """Append-only JSONL metrics: one record per log() call with a
    wall-clock timestamp and step."""

    def __init__(self, path: str, echo: bool = True):
        self.path = os.path.abspath(os.path.expanduser(path))
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a")
        self.echo = echo

    def log(self, step: int, **metrics: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "step": int(step)}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self.echo:
            print("  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "ts"
            ))

    def close(self) -> None:
        self._fh.close()
