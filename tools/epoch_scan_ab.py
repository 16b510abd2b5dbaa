#!/usr/bin/env python3
"""Check and time the epoch scan (K1) of one source tree, for A/B comparisons.

    python3 tools/epoch_scan_ab.py [SRC_DIR] [--rates 32] [--seeds 32]
        [--jobs 1000] [--check-every 16] [--verbose] [--sweep]
        [--governor ondemand|throttle] [--faults] [--grid b|c|d]

Builds the kernels of ``SRC_DIR`` (default: this checkout's ``src``; with
``--verbose`` prints ptxas's report of ``epoch_scan_kernel``), then for each
scheduler (etf, met, table) runs K1 on the paper's five-app mix on
``DesignPoint(num_vit=1)`` (T=8, P=15): ``rates`` injection rates from 1 to
80 jobs/ms x ``seeds`` seeds of Poisson traces of ``jobs`` jobs, one launch
for all lanes.  Every ``check-every``-th lane also goes through the plain scan
and must equal K1 bit for bit (0 skips the check).  Prints K1's device time
per launch (CUDA events around one launch, median of 5 after one warm-up),
scheduled tasks per second, resident lanes per SM, and the byte bound (the
tables and the (L, J) lanes read once, the (L, J, T) schedule written once, at
3.35 TB/s).  ``--sweep`` instead times one lane per SM at J = 80 and 1000 and
rates 1 ... 80 jobs/ms (see ``sweep``): a lone warp of a tree whose K1 runs
a warp a lane, a lone block of 256 threads of one before it.  ``--grid``
instead runs the tree's ``sweep`` over ``chip_smoke.py`` phase 7's grid (b),
(c) or (d) and times each K1 launch it makes again on the same inputs (see
``grid``).  ``--governor`` runs K1's DTPM variant instead of the static one (ondemand with its defaults; throttle with a 27 C
cap and a 0.05 s RC step, as ``benchmarks/bench_dtpm.py`` sets them): the
grid prints windows a lane beside the steps, its check takes every
``check-every``-th lane of the highest rate only (the plain loop runs the
longest checked lane's windows, ~20,000 at 1 job/ms), and ``--sweep`` prints
a lone block's µs per step (the static kernel on the same lanes) and µs per
window (what DTPM adds, over the windows of a lane).  ``--faults`` runs K1's
fail-stop instantiation (etf and met) on 1 + P copies of the grid: none, and
each of the P PEs lost at each lane's arrival of job ``jobs / 2`` (as
``chip_smoke.py`` builds its fault grid), and prints re-commits beside the
time; its check takes the last fault set's highest-rate lanes.  Two versions are
compared inside ONE job on one card, in turns:

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
# the DTPM cells: governor -> governor_params
GOVERNORS = {"ondemand": (),
             "throttle": (("thermal_cap_c", 27.0), ("thermal_dt_s", 0.05))}


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
    ap.add_argument("--governor", choices=sorted(GOVERNORS),
                    help="run K1's DTPM variant under this governor")
    ap.add_argument("--faults", action="store_true",
                    help="run K1's fail-stop variant over single-PE losses")
    ap.add_argument("--grid", choices=("b", "c", "d"),
                    help="time K1's launches of chip_smoke.py phase 7's grid")
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
    if args.governor:                      # trees before DTPM lack it
        from repro_torch.core.dvfs import policy_lanes
    # a tree before the warp-a-lane K1 runs a block of THREADS threads a lane
    width = (f", a block of {k1.THREADS} threads a lane"
             if hasattr(k1, "THREADS") else ", a warp a lane")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.verbose:
        for src in _build.sources():       # ptxas reports only a fresh build
            _build._lib_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.build_all(verbose=args.verbose)
    print(f"from {args.src}: built in {time.perf_counter() - t0:.1f} s{width}  "
          f"[{smi}]", flush=True)

    dev = torch.device("cuda", 0)
    if args.sweep:
        return sweep(dev, smi, args.governor)
    if args.grid:
        return grid(smi, args.grid)
    traces = [poisson_trace(float(r), args.jobs, APPS5, seed=s)
              for r in np.linspace(1.0, 80.0, args.rates)
              for s in range(args.seeds)]
    arrival = torch.from_numpy(np.stack([t.arrival_us for t in traces])).to(dev)
    app_idx = torch.from_numpy(np.stack([t.app_index for t in traces])).to(dev)
    L, J = arrival.shape
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    gov_name = args.governor
    if gov_name:
        base = base.replace(governor=gov_name,
                            governor_params=GOVERNORS[gov_name])
    pol = base.make_policy() if gov_name else None
    out_keys = ("scheduled", "start", "finish", "onpe")
    if gov_name:
        out_keys += ("onopp", "opp_idx", "peak_temp_c")
    fault_kw, plain_kw = {}, {}
    if args.faults:
        # lanes (1 + P fault sets) x traces: none, then PE p lost at job J/2
        P = base.design.num_pes
        N = L
        plans = torch.full((P + 1, N, P), float("inf"), device=dev)
        half = arrival[:, J // 2]
        for pe in range(P):
            plans[pe + 1, :, pe] = half
        plans = plans.reshape(-1, P)
        arrival, app_idx = arrival.repeat(P + 1, 1), app_idx.repeat(P + 1, 1)
        L = arrival.shape[0]
        fault_kw = {"faults": plans}
        out_keys += ("counts",)
    for policy in ("etf", "met") if args.faults else ("etf", "met", "table"):
        tables = tables_for(base.replace(scheduler=policy), device=dev)
        A, T, P = tables.exec_us.shape
        C, K = tables.opp_freq.shape if gov_name else (0, 0)
        # a parent tree's K1 takes neither C, K nor gov=
        dtpm_kw = {"C": C, "K": K} if gov_name else {}
        info = k1.kernel_info(J, A, T, P, dev, **dtpm_kw,
                              **({"faults": True} if args.faults else {}))
        launch_kw = {"gov": policy_lanes(pol, L)} if gov_name else {}
        launch_kw.update(fault_kw)
        if gov_name:
            out = simkernel_torch.simulate_batch_dtpm(tables, policy, arrival,
                                                      app_idx, pol, **fault_kw)
        else:
            out = simkernel_torch.simulate_batch(tables, policy, arrival,
                                                 app_idx, **fault_kw)
        if args.faults:
            out["counts"] = torch.stack([out["steps"], out["commits"]], dim=1)
        torch.cuda.synchronize()
        if not bool(out["scheduled"].all()):
            raise AssertionError(f"{policy}: a task was left unscheduled")
        check = ""
        if args.check_every:
            # DTPM: the highest rate's lanes only (fewest windows)
            first = L - args.seeds if gov_name else 0
            lanes = torch.arange(first, L, args.check_every, device=dev)
            sub = [policy_lanes(pol, len(lanes)) if gov_name else None]
            if args.faults:
                sub.append(plans[lanes])
            t0 = time.perf_counter()
            plain = k1.epoch_scan_plain(tables, policy, arrival[lanes],
                                        app_idx[lanes], *sub)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            for key, want in zip(out_keys, plain):
                if not torch.equal(out[key][lanes], want):
                    raise AssertionError(f"{policy}: K1 and the plain scan "
                                         f"differ in {key}")
            check = (f"; {len(lanes)} lanes = plain bit for bit (plain "
                     f"{plain_s:.3f} s)")
        ms = launch_ms(lambda: k1.epoch_scan(tables, policy, arrival, app_idx,
                                             **launch_kw))
        per_lane = tables.valid[app_idx.long()].sum(dim=(1, 2))
        tasks, steps = int(per_lane.sum()), int(per_lane.max())
        nbytes = (4 * (A * T * P + 2 * A * T + A * T * T + A + P * P + 2)
                  + 8 * L * J + 13 * L * J * T)
        windows = ""
        if gov_name:
            nbytes += 4 * L * J * T              # the latched OPPs
            w = windows_per_lane(out["makespan_us"], pol.sample_window_us)
            windows = (f", {float(w.float().mean()):.0f} windows a lane on "
                       f"average, {int(w.max())} at most")
        if args.faults:
            nbytes += 4 * (L * P + L * J * T + 2 * L)  # plans, floor, counts
            windows += (f", {int(out['commits'].sum()) - tasks} re-commits, "
                        f"{info['registers']} registers, "
                        f"{info['local_bytes']} local bytes")
        bound = 1e3 * nbytes / PEAK_BYTES_S
        print(f"{policy}{'/' + gov_name if gov_name else ''}: L={L} J={J} "
              f"T={T} P={P}: K1 {ms:.4f} ms a launch, "
              f"{tasks / (ms * 1e-3):.4g} tasks/s, {1e3 * ms / steps:.3f} us "
              f"per step of the longest lane{windows}, "
              f"{info.get('lanes_per_sm', info.get('blocks_per_sm'))} lanes/SM, "
              f"{info['shared_bytes']} B shared, J <= "
              f"{largest_jobs(k1, A, T, P, C, K, args.faults) or 'any'}, bound "
              f"{bound:.5f} ms (bytes){check}  [{smi}]", flush=True)


def largest_jobs(k1, A, T, P, C=0, K=0, faults=False) -> int:
    """The most jobs a lane this tree's K1 admits (its shared memory a
    block); 0 where its shared memory does not grow with J (a tree whose
    fault-free lanes keep their live jobs in a ring)."""
    if k1.shared_bytes(1 << 20, A, T, P, C, K, faults) == \
            k1.shared_bytes(1 << 10, A, T, P, C, K, faults):
        return 0
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if k1.shared_bytes(mid, A, T, P, C, K, faults) <= k1.MAX_SHARED:
            lo = mid
        else:
            hi = mid - 1
    return lo


def grid(smi, name: str):
    """K1's launches of ``chip_smoke.py`` phase 7's sweep grid ``name``, the
    mix at 1,000 Poisson jobs and 20 jobs/ms: (b) every valid design of
    ``DesignSpace().grid()`` x 4 seeds, etf and met; (c) 64 LHS designs x 16
    ondemand policies, etf and met; (d) 8 fault sets x 16 designs of more
    than 7 PEs x 8 seeds, etf.  The tree's own ``sweep`` makes the launches
    (their inputs are captured), and each is timed again as ``launch_ms``
    times one."""
    from repro_torch.dse import DesignSpace
    from repro_torch.kernels import epoch_scan as k1
    from repro_torch.scenario import FaultSpec, Scenario, TraceSpec, sweep
    base = Scenario(apps=APPS5, governor="design",
                    trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=1000, seed=0))
    space = DesignSpace()
    if name == "b":
        axes = {"scheduler": ("etf", "met"), "design": space.grid(),
                "seed": list(range(4))}
    elif name == "c":
        base = base.replace(governor="ondemand")
        axes = {"scheduler": ("etf", "met"), "design": space.sample_lhs(64, seed=0),
                "governor_params": tuple(
                    (("up_threshold", u), ("sample_window_us", w))
                    for u in (0.6, 0.7, 0.8, 0.9) for w in (25.0, 50.0, 100.0, 200.0))}
    else:
        wide = [p for p in space.grid() if p.num_pes > 7]
        axes = {"faults": ((),) + tuple((FaultSpec(pe, 500.0),) for pe in range(7)),
                "design": wide[::len(wide) // 16][:16], "seed": list(range(8))}
    launches, scan = [], k1.epoch_scan

    def capture(*args, **kw):
        launches.append((args, kw))
        return scan(*args, **kw)
    k1.epoch_scan = capture
    try:
        sweep(base, axes)
    finally:
        k1.epoch_scan = scan
    for args, kw in launches:
        ms = launch_ms(lambda: scan(*args, **kw))
        print(f"grid ({name}): {args[1]}: K1 {ms:.4f} ms a launch of "
              f"{args[2].shape[0]} lanes  [{smi}]", flush=True)


def windows_per_lane(makespan_us, window_us: float):
    """Sampling windows a DTPM lane runs: they advance to the makespan and
    one past it (floor(makespan / window) + 1; f32 sums of the window may
    move the last by one)."""
    return (makespan_us.double() / window_us).floor().long() + 1


def sweep(dev, smi, gov_name=None):
    """What a scan step costs, by how much a step walks: one lane per SM (so
    no block shares its SM), etf, J = 80 and 1000 jobs at 1 ... 80 jobs/ms.
    Jobs in the system (rate x mean latency, Little's law) is how many open
    jobs a step of a tree that walks every job visits on average; a step
    that costs the same at any load and J is bound by its fixed serial part
    (a tree before the warp-a-lane K1: two barriers, warp 0's reduction and
    its dependent loads), one that grows with load or J by a walk.

    With ``gov_name`` every lane runs one trace (seed 0), so the launch is
    one lane's chain: the static kernel on the static tables gives µs per
    step, and the DTPM kernel's extra time over that lane's windows µs per
    window."""
    from repro_torch.core import simkernel_torch
    from repro_torch.core.jobgen import poisson_trace
    from repro_torch.dse import DesignPoint
    from repro_torch.kernels import epoch_scan as k1
    from repro_torch.scenario import Scenario, tables_for
    if gov_name:
        from repro_torch.core.dvfs import policy_lanes

    L = torch.cuda.get_device_properties(dev).multi_processor_count
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    tables = tables_for(base, device=dev)
    if gov_name:
        dyn = base.replace(governor=gov_name, governor_params=GOVERNORS[gov_name])
        pol = dyn.make_policy()
        dyn_tables = tables_for(dyn, device=dev)
        lanes_pol = policy_lanes(pol, L)
    for J in (80, 1000):
        for rate in (1.0, 10.0, 20.0, 40.0, 80.0):
            seeds = [0] * L if gov_name else range(L)
            traces = [poisson_trace(rate, J, APPS5, seed=s) for s in seeds]
            arrival = torch.from_numpy(
                np.stack([t.arrival_us for t in traces])).to(dev)
            app_idx = torch.from_numpy(
                np.stack([t.app_index for t in traces])).to(dev)
            out = simkernel_torch.simulate_batch(tables, "etf", arrival, app_idx)
            in_system = rate * 1e-3 * float(out["avg_job_latency_us"].mean())
            steps = float(tables.valid[app_idx.long()].sum(dim=(1, 2)).max())
            ms = launch_ms(lambda: k1.epoch_scan(tables, "etf", arrival, app_idx))
            extra = ""
            if gov_name:
                dout = simkernel_torch.simulate_batch_dtpm(
                    dyn_tables, "etf", arrival, app_idx, pol)
                windows = int(windows_per_lane(dout["makespan_us"],
                                               pol.sample_window_us).max())
                ms_d = launch_ms(lambda: k1.epoch_scan(
                    dyn_tables, "etf", arrival, app_idx, gov=lanes_pol))
                extra = (f"; {gov_name}: K1 {ms_d:.4f} ms, {windows} windows, "
                         f"{1e3 * (ms_d - ms) / windows:.3f} us a window over "
                         f"the static steps")
            print(f"sweep: L={L} J={J} rate={rate:g}/ms: K1 {ms:.4f} ms, "
                  f"{1e3 * ms / steps:.3f} us a step, {in_system:.1f} jobs in "
                  f"the system (rate x latency){extra}  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
