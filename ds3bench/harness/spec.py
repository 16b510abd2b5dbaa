"""Finds a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root names the cells (``workloads``), their
configuration and traffic, and the metrics.  The files of each are found by
name, so a cell, a configuration, a traffic mix or a metric is added by
adding files and entries, never by editing one:

* a configuration: the ``file`` its entry gives (``ds3bench/configs/``);
* a traffic mix: ``ds3bench/traffic/<traffic>.json``;
* a cell's limits on the numbers that decide ``correct``:
  ``ds3bench/limits/<workload>.json``;
* a metric: a reader ``ds3bench/metrics/<metric>.py`` with ``read(run)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = "ds3bench"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool
    read: Callable


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def metrics(self) -> List[Metric]:
        return self.end_to_end + self.per_layer


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(root: Path, name: str) -> Callable:
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ds3bench_metric_{name}",
                                                  path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = read_json(root / BENCH_DIR / "limits" / f"{workload}.json")

    def metrics(key: str, e2e: bool) -> List[Metric]:
        return [Metric(m["name"], m["unit"], e2e, _reader(root, m["name"]))
                for m in bench[key] if _applies(m, workload)]

    return Cell(workload, int(w["chips"]), config, traffic,
                {k: float(v) for k, v in limits["limits"].items()},
                metrics("end_to_end", True), metrics("per_layer", False))
