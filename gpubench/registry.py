"""Finding what belongs to a cell by its name: BENCHMARK.json's entries,
the data files of configurations, traffic mixes and limits, and the
modules of metrics, drivers, program builders and references. Modules are
loaded from their file (a metric's name may hold dots)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_loaded: Dict[Path, ModuleType] = {}


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def data(kind: str, name: str) -> dict:
    """`gpubench/<kind>/<name>.json`."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """`gpubench/<kind>/<name>.py`, loaded once."""
    path = HERE / kind / f"{name}.py"
    if path not in _loaded:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"gpubench.{kind}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    cell reports: those that list it under `workloads`; without that key,
    an end-to-end metric in every cell and a per-layer one in every cell
    that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if section == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
