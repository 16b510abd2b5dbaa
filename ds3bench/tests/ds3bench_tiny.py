"""Tiny cells for the CPU tests: each real cell's configuration, entry and
limits at a size the CPU holds, and fail-stop fault sweeps on the Table-2
SoC, added as data files alone beside a copy of the benchmark's files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "ds3bench"

# (tiny cell, real cell whose configuration, traffic and limits it shrinks)
TINY = {
    "tiny-rate-sweep": "static-rate-sweep",
    "tiny-policy-sweep": "dtpm-policy-sweep",
    "tiny-grid-evaluate": "dse-grid-evaluate",
}

# (tiny fault cell, (configuration it copies, limits it copies, the axes
# before the fault axis)): the Table-2 SoC with none, PE 0 (big), an FFT
# (PE 10) or the Viterbi (PE 14) lost at 1 ms, inside the ~3 ms of
# arrivals of the cell's traces of 60 jobs at 20 jobs/ms
FAULTS = {
    "tiny-fault-sweep": ("ds3-soc-static", "static-rate-sweep",
                         [["scheduler", ["etf", "met"]]]),
    "tiny-fault-policy-sweep": ("ds3-soc-dtpm-seconds", "dtpm-policy-sweep",
                                [["governor_params", "policies"]]),
}
FAULT_SETS = [[], [[0, 1000.0]], [[10, 1000.0]], [[14, 1000.0]]]
CELLS = sorted(TINY) + sorted(FAULTS)


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def _write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, check_lanes: int = 64) -> Path:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` with the real
    cells and the tiny ones, and ``ds3bench/`` with the real data files and
    the tiny cells' configurations, traffic and limits."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "ds3bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _read(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for tiny, real in TINY.items():
        w = dict(cells[real], name=tiny, config=f"{tiny}-config",
                 traffic=tiny)
        bench["workloads"].append(w)
        cfg = _read(ROOT / configs[cells[real]["config"]]["file"])
        tr = _read(BENCH / "traffic" / f"{cells[real]['traffic']}.json")
        # a few designs of the real set, the first and the narrowest ones
        rows = cfg["designs"][tr["designs"]]
        keep = sorted(rows, key=lambda r: sum(r[:5]))[:2] + rows[-1:]
        cfg = dict(cfg, name=f"{tiny}-config",
                   designs={tr["designs"]: keep if len(rows) > 1 else rows})
        if "policies" in cfg:
            cfg["policies"] = [cfg["policies"][0], cfg["policies"][-1]]
        path = f"ds3bench/configs/{tiny}-config.json"
        _write(root / path, cfg)
        bench["configs"].append(dict(configs[cells[real]["config"]],
                                     name=f"{tiny}-config", file=path))
        rates = [5.0, 60.0] if tr["traces"]["per_rate"] > 1 else [20.0]
        tr = dict(tr, pool=2, check_lanes=check_lanes, trace_calls=1,
                  traces=dict(tr["traces"], rates_jobs_per_ms=rates,
                              per_rate=2 if len(rates) == 1 else 1, jobs=40))
        _write(root / "ds3bench" / "traffic" / f"{tiny}.json", tr)
        shutil.copy(BENCH / "limits" / f"{real}.json",
                    root / "ds3bench" / "limits" / f"{tiny}.json")
    for tiny, (config, limits, axes) in FAULTS.items():
        bench["workloads"].append(dict(
            name=tiny, config=f"{tiny}-config", traffic=tiny, chips=1,
            why="fail-stop lanes on the CPU"))
        cfg = _read(ROOT / configs[config]["file"])
        cfg = dict(cfg, name=f"{tiny}-config",
                   designs={"table2": cfg["designs"]["table2"]},
                   governors={"table2": cfg["governors"]["table2"]},
                   fault_sets={"pe_loss": FAULT_SETS})
        if "policies" in cfg:
            cfg["policies"] = [cfg["policies"][0], cfg["policies"][-1]]
        path = f"ds3bench/configs/{tiny}-config.json"
        _write(root / path, cfg)
        bench["configs"].append(dict(configs[config], name=f"{tiny}-config",
                                     file=path))
        _write(root / "ds3bench" / "traffic" / f"{tiny}.json", dict(
            about="fail-stop PE loss on the Table-2 SoC", entry="sweep",
            designs="table2", scheduler="etf", fault_sets="pe_loss",
            axes=axes + [["faults", "faults"], ["trace", "traces"]],
            traces={"rates_jobs_per_ms": [20.0], "per_rate": 3, "jobs": 60},
            pool=2, check_lanes=check_lanes, trace_calls=1))
        shutil.copy(BENCH / "limits" / f"{limits}.json",
                    root / "ds3bench" / "limits" / f"{tiny}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                t for t, r in TINY.items() if r in m["workloads"]]
    _write(root / "BENCHMARK.json", bench)
    return root
