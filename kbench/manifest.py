"""``BENCHMARK.json`` and the files the harness finds by name.

A cell's configuration is the file its ``configs`` entry names; its traffic
mix is ``kbench/traffic/<cell>.json``; a per-layer metric's reader is
``kbench/metrics/<metric>.py`` with a ``read(run)`` function.  A
configuration names its generator module (``generator``, by default
``kbench/gen/cluster.py``) and its plain reference (``reference``), each a
path from the checkout's root.  A later change adds a configuration, a
cell or a metric by adding files and entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent
# the generator of a configuration that names none
DEFAULT_GENERATOR = "kbench/gen/cluster.py"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT

    @property
    def generator(self) -> ModuleType:
        """The configuration's generator: ``build(config, seed)``,
        ``BindLoop(model, lifetime_steps, seed)``, ``full_sync_kwargs(model)``,
        ``sync_kwargs(before, after)``, optionally ``running_band(config,
        traffic)``."""
        return load_module(self.config.get("generator", DEFAULT_GENERATOR), self.root)

    @property
    def reference(self) -> ModuleType:
        """The configuration's plain reference: ``Semantics(cycle)``,
        ``score_reply``, ``assign_reply``."""
        return load_module(self.config["reference"], self.root)


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
    out = Cell(
        name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in doc["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in doc["per_layer"] if _applies(m, name)], root=root,
    )
    # a generator or a reference that is not there fails here, by its path
    _ = (out.generator, out.reference)
    return out


def load_module(path: str, root: Path = ROOT) -> ModuleType:
    """The Python file at ``path`` (from ``root``), loaded once.  A file of
    this package is imported under its dotted name, so that it is the same
    module as an ``import`` of it; any other is loaded from its file."""
    file = (root / path).resolve()
    if not file.is_file():
        raise FileNotFoundError(f"no module file {path!r} (looked for {file})")
    if file.is_relative_to(PACKAGE):
        return importlib.import_module(".".join(file.relative_to(ROOT).with_suffix("").parts))
    name = "kbench_file_" + hashlib.sha1(str(file).encode()).hexdigest()[:16]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, file)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], object]:
    """The ``read`` function of ``kbench/metrics/<metric>.py``."""
    path = root / "kbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"kbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], root) for m in cell.per_layer}
