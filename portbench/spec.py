"""Find what ``BENCHMARK.json`` names: a cell's configuration file, its
traffic mix (``traffic/<name>.json``), its limits (``limits/<cell>.json``),
its driver (``drivers/<kind>.py``, the traffic mix's ``kind``) and the
reader of each metric (``metrics/<metric>.py``). A cell, a configuration,
a traffic mix or a metric is added by adding files and entries: nothing
here lists them."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


def repo_root() -> Path:
    return HERE.parent


def load_benchmark(root: Optional[Path] = None) -> dict:
    return json.loads(((root or repo_root()) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Optional[Path] = None) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads(((root or repo_root()) / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str) -> ModuleType:
    """The module ``metrics/<metric>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    if spec is None or not path.exists():
        raise KeyError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it under ``workloads``, and those without
    the key (a per-layer one then wherever its ``moves`` metric is)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return workload in m["workloads"]
        if section == "per_layer":
            return reports(e2e[m["moves"]])
        return True

    return [m for m in bench[section] if reports(m)]
