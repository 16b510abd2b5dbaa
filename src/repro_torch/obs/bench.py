"""Shared benchmark CLI harness, on the port.

The twin of ``src/repro/obs/bench.py``.  A benchmark module exposes
``run() -> [(name, value, derived), ...]``; :func:`bench_cli` is the one
``main()`` they share — it prints the CSV rows, and under ``--json`` writes a
schema-tagged payload ``{"manifest": <run manifest>, "rows": [...]}`` so
every ``BENCH_*.json`` is self-describing (scenario hashes, the device it
ran on, K1's launches, wall time).  ``python -m repro_torch.obs.report
BENCH_x.json`` (or the reference's report: the schemas are the same)
renders these.

``--smoke`` asks the benchmark for scaled-down inputs: a ``run(smoke=...)``
signature receives the flag and picks sizes via :func:`scaled`.
``--device`` (default ``cuda``, which raises where there is no card) is
passed to a ``run(device=...)`` signature and names the device in the
manifest.  ``--devices N`` is the reference's virtual host-device count:
here it runs the benchmark under ``sharding.virtual_lane_devices(N)`` on
``--device`` (a sweep shards its lanes over N blocks of that device, a
stream each on a card), and the manifest records the lane devices as
``lane_devices``; without it the lane devices are the process's own.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
from typing import Callable, List, Optional, Sequence, Tuple

from . import metrics
from .. import sharding

BENCH_SCHEMA = "repro.obs/bench/v1"

Rows = List[Tuple[str, float, str]]


def scaled(full, smoke_value, smoke: bool):
    """Pick the benchmark input size: ``full`` normally, ``smoke_value``
    under ``--smoke`` (the fast lane)."""
    return smoke_value if smoke else full


def rows_payload(rows: Rows, name: str, wall_s: float, device=None,
                 **extra) -> dict:
    """The ``BENCH_*.json`` payload: run manifest (naming ``device``, where
    given) + measurement rows."""
    return {
        "schema": BENCH_SCHEMA,
        "manifest": metrics.run_manifest(device=device, bench=name,
                                         wall_s=wall_s, **extra),
        "rows": [dict(name=n, value=float(v), derived=str(d))
                 for n, v, d in rows],
    }


def bench_cli(run_fn: Callable[..., Rows], name: str,
              description: Optional[str] = None,
              argv: Optional[Sequence[str]] = None) -> int:
    """Run one benchmark module as a CLI: print the CSV rows, honour the
    ``--json PATH``, ``--smoke``, ``--device`` and ``--devices`` flags."""
    from .. import resolve_device
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--json", metavar="PATH",
                    help="also dump rows + run manifest as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down inputs: the fast lane")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default: cuda; raises where "
                         "there is none; 'cpu' runs the plain versions)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="N virtual lane devices on --device to shard sweep "
                         "lanes over (default: the process's devices)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lanes = (contextlib.nullcontext() if args.devices is None
             else sharding.virtual_lane_devices(args.devices))
    kwargs = {}
    params = inspect.signature(run_fn).parameters
    if "smoke" in params:
        kwargs["smoke"] = args.smoke
    if "device" in params:
        kwargs["device"] = dev
    wall = metrics.timer(f"bench.{name}.wall")
    with lanes:
        n_lanes = len(sharding.lane_devices(dev))
        with wall:
            rows = run_fn(**kwargs)
    print("name,value,derived")
    for n, v, d in rows:
        print(f"{n},{v:.4f},{d}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows_payload(rows, name, wall.last_s, device=dev,
                                   smoke=args.smoke, lane_devices=n_lanes),
                      fh, indent=2)
    return 0
