"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each metric of ``end_to_end`` and ``per_layer`` names its reader. Every file
is found by name, so a later cell or metric adds files and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names, loaded."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports with --trace 0
    per_layer: list = field(default_factory=list)  # metric entries this cell reports with --trace 1

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file of this folder as a module, by path: metric files are
    named after metrics, whose names hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family_module(kind: str, family: str) -> ModuleType:
    """``<kind>/<family>.py`` (kind: weights, reference or counts)."""
    return importlib.import_module(f"port_bench.{kind}.{family}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: UNIT, LAYER, MOVES and ``read(record)``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "port_bench_metric_" + name.replace(".", "__"))


def reports(metric: dict, workload: str) -> bool:
    """True where the metric is reported in this cell: it lists the cell, or lists none."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration
    file (the entry's ``file``, under ``root``) and its traffic and limits
    files (``traffic/`` and ``limits/`` beside ``port_bench/``'s, under
    ``root``) read."""
    bench = load_json(root / "BENCHMARK.json")
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if len(matches) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")
    workload = matches[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[workload["config"]]["file"])
    traffic = load_json(root / "port_bench" / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(root / "port_bench" / "limits" / f"{name}.json")
    return Cell(
        workload=workload,
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )
