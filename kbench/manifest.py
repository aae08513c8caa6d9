"""``BENCHMARK.json`` and the files the harness finds by name.

A cell's configuration is the file its ``configs`` entry names; its traffic
mix is ``kbench/traffic/<cell>.json``; a per-layer metric's reader is
``kbench/metrics/<metric>.py`` with a ``read(run)`` function.  A later
change adds a configuration, a cell or a metric by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    doc = load_manifest(root)
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in doc["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "kbench" / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    if traffic.get("mix_name") != cell["traffic"]:
        raise ValueError(f"kbench/traffic/{name}.json holds mix {traffic.get('mix_name')!r}, "
                         f"BENCHMARK.json names {cell['traffic']!r}")
    return Cell(
        name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in doc["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in doc["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], object]:
    """The ``read`` function of ``kbench/metrics/<metric>.py``."""
    path = root / "kbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"kbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], root) for m in cell.per_layer}
