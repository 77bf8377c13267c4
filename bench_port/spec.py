"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, read from
``bench_port/configs/<config>.json``, and a traffic mix, read from
``bench_port/workloads/<traffic>.json``.  Its metrics are the entries of
``end_to_end`` and ``per_layer`` that list the cell under ``workloads`` (or
list no cells).  A per-layer metric's reader is
``bench_port/metrics/<metric>.py``, whose ``read(ctx)`` returns a number, or
``None`` where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    #: the checkout whose files the cell was read from
    root: Path
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[Dict], name: str) -> List[Dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and metrics; ``KeyError`` for a name the file does not list."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(root / "bench_port" / "workloads" / f"{entry['traffic']}.json")
    return Cell(name=name, root=root, chips=int(entry["chips"]), config=config, traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def metric_reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``root/bench_port/metrics/<metric>.py``."""
    path = root / "bench_port" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
