"""DSE reporting + CLI entry point, on PyTorch.

The twin of ``src/repro/dse/reports.py``.  ``python -m
repro_torch.dse.reports --designs 64 --traces 4`` sweeps a latin-hypercube
batch (or runs the refinement loop with ``--rounds > 1``) on the card and
prints the non-dominated (latency, energy, peak-temp) front as an ASCII
table plus a CSV block, with a design-points/sec figure for the batched
evaluator.  ``--device cpu`` runs K1's plain version instead.
"""
from __future__ import annotations

import argparse
import io
import time
from typing import List, Optional, Sequence

import numpy as np

from ..core.applications import REFERENCE_APPS
from .pareto import pareto_order
from .search import EvalResult, SearchResult, evaluate, pareto_search
from .space import DesignSpace

_COLS = ("design", "area_mm2", "avg_latency_us", "energy_j", "peak_temp_c")


def _front_rows(result: EvalResult) -> List[dict]:
    obj = result.objectives()
    mask = result.front_mask()
    idx = np.flatnonzero(mask)
    order = pareto_order(obj[mask])
    rows = []
    for i in order:
        p = result.points[idx[i]]
        rows.append(dict(design=p.label(), area_mm2=p.area_mm2,
                         avg_latency_us=obj[idx[i], 0],
                         energy_j=obj[idx[i], 1],
                         peak_temp_c=obj[idx[i], 2]))
    return rows


def format_front(result: EvalResult) -> str:
    """ASCII table of the non-dominated front, best-crowding first."""
    rows = _front_rows(result)
    out = io.StringIO()
    out.write(f"Pareto front: {len(rows)} of {result.num_designs} designs\n")
    out.write(f"{'design':>26} {'area':>7} {'latency_us':>11} "
              f"{'energy_j':>10} {'peak_C':>7}\n")
    for r in rows:
        out.write(f"{r['design']:>26} {r['area_mm2']:>7.1f} "
                  f"{r['avg_latency_us']:>11.2f} {r['energy_j']:>10.4f} "
                  f"{r['peak_temp_c']:>7.2f}\n")
    return out.getvalue()


def front_csv(result: EvalResult) -> str:
    rows = _front_rows(result)
    out = io.StringIO()
    out.write(",".join(_COLS) + "\n")
    for r in rows:
        out.write(",".join(f"{r[k]:.6f}" if isinstance(r[k], float)
                           else str(r[k]) for k in _COLS) + "\n")
    return out.getvalue()


def main(argv: Optional[Sequence[str]] = None) -> EvalResult:
    ap = argparse.ArgumentParser(description="Batched SoC design-space sweep")
    ap.add_argument("--designs", type=int, default=64,
                    help="design points per batch (LHS sample)")
    ap.add_argument("--traces", type=int, default=4,
                    help="job traces (seeds) per design")
    ap.add_argument("--jobs", type=int, default=32, help="jobs per trace")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="injection rate (jobs/ms)")
    ap.add_argument("--policy", default="etf", choices=["etf", "met"])
    ap.add_argument("--apps", nargs="+", default=["wifi_tx", "wifi_rx"],
                    choices=sorted(REFERENCE_APPS), help="application mix")
    ap.add_argument("--rounds", type=int, default=1,
                    help=">1 runs the Pareto refinement loop")
    ap.add_argument("--budget-mm2", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--csv", action="store_true", help="also print CSV")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs K1's plain "
                         "version)")
    args = ap.parse_args(argv)

    # scenario construction lives in the facade: one declarative config
    from ..scenario import Scenario, TraceSpec
    base = Scenario(apps=tuple(args.apps), scheduler=args.policy,
                    trace=TraceSpec(rate_jobs_per_ms=args.rate,
                                    num_jobs=args.jobs, seed=args.seed))
    apps = base.applications()
    traces = [base.with_seed(args.seed + s).job_trace()
              for s in range(args.traces)]
    space = DesignSpace()

    t0 = time.perf_counter()
    if args.rounds > 1:
        sr: SearchResult = pareto_search(
            space, apps, traces, policy=args.policy, rounds=args.rounds,
            batch_size=args.designs, seed=args.seed,
            budget_mm2=args.budget_mm2, device=args.device)
        result = sr.archive
        for st in sr.rounds:
            print(f"round {st['round']}: evaluated {st['evaluated']:>4} | "
                  f"archive {st['archive']:>4} | front {st['front']:>3}")
    else:
        points = space.sample_lhs(args.designs, seed=args.seed,
                                  budget_mm2=args.budget_mm2)
        result = evaluate(points, apps, traces, policy=args.policy,
                          device=args.device)
    dt = time.perf_counter() - t0

    print(format_front(result))
    sims = result.num_designs * len(traces)
    print(f"{result.num_designs} designs x {len(traces)} traces "
          f"({sims} simulations) in {dt:.2f}s "
          f"= {result.num_designs / dt:.1f} design-points/sec "
          f"(incl. kernel build)")
    if args.csv:
        print(front_csv(result))
    return result


if __name__ == "__main__":
    main()
