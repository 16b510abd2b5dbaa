#!/usr/bin/env python3
"""Time the tables layer of one source tree on the host, for A/B comparisons.

    python3 tools/tables_ab.py [SRC_DIR] [--device cpu|cuda] [--reps 5]

Builds ``repro_torch.dse.build_design_batch`` over the design sets of the
benchmark's cells, with the five reference apps: every design of
``DesignSpace().grid()`` (1,080) under its own caps, as ``evaluate``
builds it in the DSE cell, and the 64 designs of ``sample_lhs(64, seed=0)``
under ondemand (the OPP tables of the DTPM cells).  Prints one JSON line a
set: the median and the spread of ``--reps`` timed builds after one warm
build, host clock, the copy to ``--device`` included (a CUDA device is
synchronised before the clock stops).  ``SRC_DIR`` (default: this checkout's
``src``) may be the ``src`` of another commit unpacked beside it; compare
two versions in one job, in turns:

    for t in parent/src src src parent/src; do python3 tools/tables_ab.py $t; done

Needs no card (``--device cpu``, the default); the host and its load set the
numbers, so compare only runs of one job.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
APPS = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
        "pulse_doppler")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.core.applications import get_application
    from repro_torch.core.dvfs import OndemandGovernor
    from repro_torch.dse import DesignSpace, build_design_batch

    apps = [get_application(n) for n in APPS]
    space = DesignSpace()
    sets = (("grid-static", space.grid(), None),
            ("lhs64-ondemand", space.sample_lhs(64, seed=0),
             OndemandGovernor()))

    def build(points, governor):
        batch = build_design_batch(points, apps, governor=governor,
                                   device=args.device)
        if batch.tables.device.type == "cuda":
            torch.cuda.synchronize(batch.tables.device)

    for name, points, governor in sets:
        build(points, governor)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            build(points, governor)
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
        print(json.dumps({"src": args.src, "set": name,
                          "designs": len(points), "device": args.device,
                          "median_ms": statistics.median(times),
                          "iqr_ms": q[2] - q[0], "ms": times}), flush=True)


if __name__ == "__main__":
    main()
