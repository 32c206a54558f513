"""What `BENCHMARK.json` and the files beside it say about a cell.

Every cell, configuration, traffic mix, correctness limit and per-layer
metric is found by its name: `configs/<config>.json` (by the `file` that
`BENCHMARK.json` gives), `traffic/<traffic>.json`, `limits/<cell>.json`
and `metrics/<metric>.py`.  A later cell or metric adds files; it edits
none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                     f"(there are {[w['name'] for w in bench['workloads']]})")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise SystemExit(f"perfbench: no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict:
    return _json(HERE / "limits" / f"{cell_name}.json")


def _in_cell(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _in_cell(m, cell_name)]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    return [m for m in bench["per_layer"] if _in_cell(m, cell_name)]


def reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric, `metrics/<metric>.py` (a name may hold
    dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"perfbench: no reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
