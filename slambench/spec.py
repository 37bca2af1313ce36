"""BENCHMARK.json and the files it names, found by name: a configuration
in configs/<name>.json, a traffic mix in traffic/<name>.json, a scene in
scenes/<name>.json, a per-layer metric's reader in metrics/<name>.py and
a cell's correctness limits in limits/<cell>.json. Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # BENCHMARK.json's entries that this cell reports
    per_layer: List[dict]
    limits: Optional[dict]  # {number: limit}; None when not set yet


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """A metric with a `workloads` list is reported in those cells; one
    without, in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, base: Path = HERE) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((base.parent / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = base / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        limits=limits,
    )


def metric_reader(name: str, base: Path = HERE) -> Callable:
    """metrics/<name>.py's `read(ctx) -> float or None`."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
