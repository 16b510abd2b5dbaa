"""``python -m repro_torch.obs.report`` — render run/bench artifacts.

The twin of ``src/repro/obs/report.py``; the files of either package render
in either.  Three things, composable in one invocation:

* positional JSON files — ``BENCH_*.json`` payloads (manifest + rows) or
  telemetry dumps — are rendered as timeline/manifest summaries;
* ``--trace PATH`` [``--telemetry PATH``] — run the scenario described by
  the CLI knobs through the event-heap kernel (``backend="ref"``, on the
  host: only it keeps the per-task records a trace needs) with telemetry
  recording and write the Perfetto-loadable Chrome trace (and the telemetry
  JSON): one thread track per PE, counter tracks for frequency/utilisation/
  temperature;
* ``--validate PATH`` — schema-check an existing Chrome trace file (required
  keys, monotonic ts, matched B/E pairs); non-zero exit on violations.

Examples::

    python -m repro_torch.obs.report BENCH_dtpm.json
    python -m repro_torch.obs.report --governor ondemand --trace TRACE_ref.json \
        --telemetry TELEMETRY_ref.json
    python -m repro_torch.obs.report --validate TRACE_ref.json
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from .bench import BENCH_SCHEMA
from .metrics import MANIFEST_SCHEMA
from .telemetry import TELEMETRY_SCHEMA, Telemetry
from .trace import chrome_trace, validate_chrome_trace, write_chrome_trace


def _print_manifest(man: dict) -> None:
    keys = ("timestamp", "scenario", "scenario_hash", "backend", "bench",
            "device_platform", "device_kind", "device_count", "torch_version",
            "cuda_version", "k1_launches", "scan_calls", "thermal_launches",
            "wall_s")
    print("manifest:")
    for k in keys:
        if k in man:
            print(f"  {k:18s} {man[k]}")


def _print_telemetry(tel: Telemetry, label: str = "telemetry") -> None:
    W, C = tel.num_windows, tel.num_domains
    print(f"{label}: {W} windows x {tel.window_us:g} us, {C} domains")
    if W == 0:
        return
    for c in range(C):
        f = tel.freq_ghz[:, c]
        moves = int(np.count_nonzero(np.diff(tel.freq_idx[:, c])))
        print(f"  cl{c}: freq {f.min():.2f}-{f.max():.2f} GHz "
              f"({moves} transitions), util mean "
              f"{tel.util[:, c].mean():.2f} max {tel.util[:, c].max():.2f}")
    print(f"  power: avg {tel.avg_power_w:.3f} W, "
          f"peak temp {tel.peak_temp_c:.2f} C")


def _report_file(path: str) -> None:
    with open(path) as fh:
        payload = json.load(fh)
    schema = payload.get("schema") if isinstance(payload, dict) else None
    print(f"== {path} ==")
    if schema == TELEMETRY_SCHEMA:
        _print_telemetry(Telemetry.from_dict(payload))
    elif schema == BENCH_SCHEMA:
        _print_manifest(payload.get("manifest", {}))
        rows = payload.get("rows", [])
        print(f"rows ({len(rows)}):")
        for r in rows:
            print(f"  {r['name']:40s} {r['value']:>14.4f}  {r['derived']}")
    elif schema == MANIFEST_SCHEMA:
        _print_manifest(payload)
    elif isinstance(payload, dict) and "manifest" in payload:
        _print_manifest(payload["manifest"])
    else:
        print(f"  (unrecognised schema {schema!r} — nothing to render)")


def _run_and_trace(args) -> int:
    from ..scenario import Scenario, TraceSpec, run

    scn = Scenario(
        apps=tuple(args.apps), scheduler=args.scheduler,
        governor=args.governor,
        trace=TraceSpec(rate_jobs_per_ms=args.rate, num_jobs=args.jobs,
                        seed=args.seed))
    res = run(scn, backend="ref", telemetry=True)
    db = scn.soc()
    tr = chrome_trace(db, res.raw, apps=scn.applications(),
                      trace=scn.job_trace(), telemetry=res.telemetry,
                      label=scn.label())
    errs = validate_chrome_trace(tr)
    if errs:
        for e in errs:
            print(f"INTERNAL trace violation: {e}")
        return 1
    write_chrome_trace(args.trace, tr)
    print(f"wrote {args.trace}: {len(tr['traceEvents'])} events "
          f"({len(res.raw.records)} tasks on {db.num_pes} PEs) — "
          f"load it at https://ui.perfetto.dev")
    if args.telemetry_out:
        with open(args.telemetry_out, "w") as fh:
            json.dump(res.telemetry.to_dict(), fh)
        print(f"wrote {args.telemetry_out}")
    _print_telemetry(res.telemetry, label=scn.label())
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="*",
                    help="BENCH_*.json / telemetry JSON files to summarise")
    ap.add_argument("--trace", metavar="PATH",
                    help="simulate (event-heap kernel, on the host) and "
                         "write the Perfetto "
                         "Chrome trace JSON here")
    ap.add_argument("--telemetry", dest="telemetry_out", metavar="PATH",
                    help="with --trace: also dump the run's telemetry JSON")
    ap.add_argument("--validate", metavar="PATH",
                    help="schema-check an existing Chrome trace JSON")
    ap.add_argument("--apps", nargs="+", default=["wifi_tx"])
    ap.add_argument("--scheduler", default="etf")
    ap.add_argument("--governor", default="ondemand")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="injection rate, jobs/ms")
    ap.add_argument("--jobs", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    status = 0
    for path in args.files:
        _report_file(path)
    if args.validate:
        with open(args.validate) as fh:
            errs = validate_chrome_trace(json.load(fh))
        if errs:
            for e in errs:
                print(f"{args.validate}: {e}")
            status = 1
        else:
            print(f"{args.validate}: valid Chrome trace")
    if args.trace:
        status = max(status, _run_and_trace(args))
    elif args.telemetry_out:
        ap.error("--telemetry requires --trace (it dumps the traced run)")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
