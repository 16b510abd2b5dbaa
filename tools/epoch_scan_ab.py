#!/usr/bin/env python3
"""Check and time the epoch scan (K1) of one source tree, for A/B comparisons.

    python3 tools/epoch_scan_ab.py [SRC_DIR] [--rates 32] [--seeds 32]
        [--jobs 1000] [--check-every 16] [--verbose] [--sweep]

Builds the kernels of ``SRC_DIR`` (default: this checkout's ``src``; with
``--verbose`` prints ptxas's report of ``epoch_scan_kernel``), then for each
scheduler (etf, met, table) runs K1 on the paper's five-app mix on
``DesignPoint(num_vit=1)`` (T=8, P=15): ``rates`` injection rates from 1 to
80 jobs/ms x ``seeds`` seeds of Poisson traces of ``jobs`` jobs, one launch
for all lanes.  Every ``check-every``-th lane also goes through the plain scan
and must equal K1 bit for bit (0 skips the check).  Prints K1's device time
per launch (CUDA events around one launch, median of 5 after one warm-up),
scheduled tasks per second, resident blocks per SM, and the byte bound (the
tables and the (L, J) lanes read once, the (L, J, T) schedule written once, at
3.35 TB/s).  ``--sweep`` instead times one lane per SM at J = 80 and 1000 and
rates 1 ... 80 jobs/ms (see ``sweep``).  Two versions are compared inside ONE
job on one card, in turns:

    for t in parent/src src src parent/src; do python3 tools/epoch_scan_ab.py $t; done

Needs one CUDA device.
"""
import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_S = 3.35e12      # H100 SXM data sheet
APPS5 = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
         "pulse_doppler")


def launch_ms(fn, iters: int = 5) -> float:
    """Median ms of one ``fn()`` between CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--rates", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--check-every", type=int, default=16)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="per-step time of K1 with one lane per SM, by jobs "
                         "and rate, instead of the A/B run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("epoch_scan_ab.py: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import simkernel_torch
    from repro_torch.core.jobgen import poisson_trace
    from repro_torch.dse import DesignPoint
    from repro_torch.kernels import _build
    from repro_torch.kernels import epoch_scan as k1
    from repro_torch.scenario import Scenario, tables_for

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.verbose:
        for src in _build.sources():       # ptxas reports only a fresh build
            _build._lib_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.build_all(verbose=args.verbose)
    print(f"from {args.src}: built in {time.perf_counter() - t0:.1f} s  [{smi}]",
          flush=True)

    dev = torch.device("cuda", 0)
    if args.sweep:
        return sweep(dev, smi)
    traces = [poisson_trace(float(r), args.jobs, APPS5, seed=s)
              for r in np.linspace(1.0, 80.0, args.rates)
              for s in range(args.seeds)]
    arrival = torch.from_numpy(np.stack([t.arrival_us for t in traces])).to(dev)
    app_idx = torch.from_numpy(np.stack([t.app_index for t in traces])).to(dev)
    L, J = arrival.shape
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    for policy in ("etf", "met", "table"):
        tables = tables_for(base.replace(scheduler=policy), device=dev)
        A, T, P = tables.exec_us.shape
        info = k1.kernel_info(J, A, T, P, dev)
        out = simkernel_torch.simulate_batch(tables, policy, arrival, app_idx)
        torch.cuda.synchronize()
        if not bool(out["scheduled"].all()):
            raise AssertionError(f"{policy}: a task was left unscheduled")
        check = ""
        if args.check_every:
            lanes = torch.arange(0, L, args.check_every, device=dev)
            t0 = time.perf_counter()
            plain = k1.epoch_scan_plain(tables, policy, arrival[lanes],
                                        app_idx[lanes])
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            for key, want in zip(("scheduled", "start", "finish", "onpe"), plain):
                if not torch.equal(out[key][lanes], want):
                    raise AssertionError(f"{policy}: K1 and the plain scan "
                                         f"differ in {key}")
            check = (f"; {len(lanes)} lanes = plain bit for bit (plain "
                     f"{plain_s:.3f} s)")
        ms = launch_ms(lambda: k1.epoch_scan(tables, policy, arrival, app_idx))
        per_lane = tables.valid[app_idx.long()].sum(dim=(1, 2))
        tasks, steps = int(per_lane.sum()), int(per_lane.max())
        nbytes = (4 * (A * T * P + 2 * A * T + A * T * T + A + P * P + 2)
                  + 8 * L * J + 13 * L * J * T)
        bound = 1e3 * nbytes / PEAK_BYTES_S
        print(f"{policy}: L={L} J={J} T={T} P={P}: K1 {ms:.4f} ms a launch, "
              f"{tasks / (ms * 1e-3):.4g} tasks/s, {1e3 * ms / steps:.3f} us "
              f"per step of the longest lane, {info['blocks_per_sm']} blocks/SM, "
              f"{info['shared_bytes']} B shared, bound {bound:.5f} ms (bytes)"
              f"{check}", flush=True)


def sweep(dev, smi):
    """What a scan step costs, by how much a step walks: one lane per SM (so
    no block shares its SM), etf, J = 80 and 1000 jobs at 1 ... 80 jobs/ms.
    Jobs in the system (rate x mean latency, Little's law) is how many open
    jobs a step's walk visits on average; a step that costs the same at any
    load is bound by its fixed serial part (two barriers, warp 0's reduction
    and its dependent loads), one that grows with load by the walk."""
    from repro_torch.core import simkernel_torch
    from repro_torch.core.jobgen import poisson_trace
    from repro_torch.dse import DesignPoint
    from repro_torch.kernels import epoch_scan as k1
    from repro_torch.scenario import Scenario, tables_for

    L = torch.cuda.get_device_properties(dev).multi_processor_count
    tables = tables_for(Scenario(design=DesignPoint(num_vit=1), apps=APPS5),
                        device=dev)
    for J in (80, 1000):
        for rate in (1.0, 10.0, 20.0, 40.0, 80.0):
            traces = [poisson_trace(rate, J, APPS5, seed=s) for s in range(L)]
            arrival = torch.from_numpy(
                np.stack([t.arrival_us for t in traces])).to(dev)
            app_idx = torch.from_numpy(
                np.stack([t.app_index for t in traces])).to(dev)
            out = simkernel_torch.simulate_batch(tables, "etf", arrival, app_idx)
            in_system = rate * 1e-3 * float(out["avg_job_latency_us"].mean())
            steps = float(tables.valid[app_idx.long()].sum(dim=(1, 2)).max())
            ms = launch_ms(lambda: k1.epoch_scan(tables, "etf", arrival, app_idx))
            print(f"sweep: L={L} J={J} rate={rate:g}/ms: K1 {ms:.4f} ms, "
                  f"{1e3 * ms / steps:.3f} us a step, {in_system:.1f} jobs in "
                  f"the system (rate x latency)  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
