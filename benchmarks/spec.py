"""What a cell is made of, found by the names in ``BENCHMARK.json``.

Every piece lives in a file of its own, so a later change adds a cell,
a configuration, a traffic mix or a metric by adding files:

* ``benchmarks/configs/<config>.json``: the model and program settings
  (the ``file`` of the configuration's entry);
* ``benchmarks/traffic/<traffic>.json``: the traffic's parameters, among
  them ``kind``, which names the driver ``benchmarks/cells/<kind>.py``;
* ``benchmarks/limits/<cell>.json``: the limits of the numbers the
  correctness comparison reports for the cell;
* ``benchmarks/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(run)`` that returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional


class Spec:
    """The benchmark of the checkout at ``root``: its ``BENCHMARK.json``
    and the files under ``root/benchmarks``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.package = self.root / "benchmarks"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return _load_json(self.root / entry["file"])
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.package / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _load_json(self.package / "limits" / f"{cell}.json")

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        without the trace, the per-layer ones with it."""
        if not trace:
            return [m for m in self.bench["end_to_end"]
                    if _applies(m, cell["name"])]
        moved = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.bench["per_layer"]
                if _applies(m, cell["name"])
                and ("workloads" in m or m["moves"] in moved)]

    def driver(self, kind: str) -> ModuleType:
        """The cell driver ``benchmarks/cells/<kind>.py``."""
        return _load_module(self.package / "cells" / f"{kind}.py",
                            f"benchmarks.cells.{kind}")

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        """The ``read`` function of ``benchmarks/metrics/<metric>.py``."""
        module = _load_module(self.package / "metrics" / f"{metric}.py",
                              "benchmarks.metrics."
                              + metric.replace(".", "_"))
        return module.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
