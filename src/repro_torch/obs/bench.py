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
manifest.  ``--devices`` is the reference's XLA virtual host-device count;
here it takes only 1: lane sharding over several cards is not ported.
"""
from __future__ import annotations

import argparse
import inspect
import json
from typing import Callable, List, Optional, Sequence, Tuple

from . import metrics

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
    ``--json PATH``, ``--smoke`` and ``--device`` flags."""
    from .. import resolve_device
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--json", metavar="PATH",
                    help="also dump rows + run manifest as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down inputs: the fast lane")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default: cuda; raises where "
                         "there is none; 'cpu' runs the plain versions)")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="devices to shard lanes over; only 1 (lane sharding "
                         "over several cards is not ported)")
    args = ap.parse_args(argv)
    if args.devices != 1:
        raise ValueError(f"--devices {args.devices}: lane sharding over "
                         "several cards is not ported (ROADMAP.md); the port "
                         "runs on one device")
    dev = resolve_device(args.device)
    kwargs = {}
    params = inspect.signature(run_fn).parameters
    if "smoke" in params:
        kwargs["smoke"] = args.smoke
    if "device" in params:
        kwargs["device"] = dev
    wall = metrics.timer(f"bench.{name}.wall")
    with wall:
        rows = run_fn(**kwargs)
    print("name,value,derived")
    for n, v, d in rows:
        print(f"{n},{v:.4f},{d}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows_payload(rows, name, wall.last_s, device=dev,
                                   smoke=args.smoke), fh, indent=2)
    return 0
