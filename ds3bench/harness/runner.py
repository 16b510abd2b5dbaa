"""One run of one cell: set-up, the measured window, the check, the result.

The client is a closed loop of one: each call waits for the previous one's
answers as numpy arrays on the host.  Set-up (imports, the CUDA context,
the epoch-scan library built or loaded, the input pool, one warm call on an
input set of its own) runs from the process's start to the first timed
call.  The window then runs calls until ``seconds`` have passed and the
call in flight has returned; every call counts.  A traced run profiles a
fixed number of calls (the traffic's ``trace_calls``) instead, with
``torch.profiler`` over CPU and CUDA activity.

After the window: the peak device memory, the modules loaded, then the
check of a sample of lanes against the plain reference (``check.py``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..reference import tasks_per_job
from . import check, entries, inputs, profile, spec
from .k1bytes import Launch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class CallRecord:
    start: float
    end: float
    tasks: int
    lanes: int
    launches: List[Launch]

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: str
    setup_s: float
    window_s: float
    calls: List[CallRecord]
    trace: Optional[profile.Summary] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def device_info(device: str, chips: int) -> dict:
    import torch
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def _power_limit() -> str:
    import subprocess
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return done.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _traced(prep: "Prepared", n: int, device: str):
    """``n`` calls under the profiler; their records, answers and the
    reduction of the trace (exported under TMPDIR, read, deleted)."""
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    records, outs = [], []
    with tprofile(activities=acts) as prof:
        for k in range(n):
            i = 1 + k % (len(prep.jts) - 1)
            t = time.perf_counter()
            with record_function(profile.CALL_SPAN):
                outs.append((i, prep.entry.call(prep.jts[i],
                                                span=record_function)))
                _sync(device)
            records.append(CallRecord(t, time.perf_counter(),
                                      prep.tasks_of[i], *prep.launches_of[i]))
    fd, path = tempfile.mkstemp(prefix="ds3bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = profile.read_trace(path)
    finally:
        os.unlink(path)
    return records, outs, summary


@dataclasses.dataclass
class Prepared:
    """A cell made ready for a run: the program's entry and the input sets
    of a seed (set 0 warms up, the window cycles through the others), each
    set's lanes, tasks and epoch-scan launches."""
    cell: spec.Cell
    entry: object
    sets: List[List[inputs.Trace]]
    jts: List[list]
    lanes: List[List[entries.Lane]]
    tasks_of: List[int]
    launches_of: List[tuple]
    shape: tuple


def prepare(root: Path, workload: str, seed: int, device: str) -> Prepared:
    cell = spec.load_cell(root, workload)
    cfg, tr = cell.config, cell.traffic
    entry = entries.make(cfg, tr, device)
    entry.build()
    per_app = tasks_per_job(cfg["apps"])
    sets = inputs.pool(tr["traces"], len(cfg["apps"]), seed, 1 + tr["pool"])
    jts = [entries.job_traces(s, cfg["apps"]) for s in sets]
    lanes = [entry.lanes(s) for s in sets]
    tasks_of, launches_of = [], []
    for s, ls in zip(sets, lanes):
        per_trace = inputs.tasks(s, per_app)
        tasks_of.append(int(sum(per_trace[l.trace] for l in ls)))
        launches_of.append((len(ls), entry.launches(s)))
    return Prepared(cell, entry, sets, jts, lanes, tasks_of, launches_of,
                    entry.shape(sets[0]))


def timed_calls(prep: Prepared, seconds: float, device: str,
                first: int = 0):
    """Calls until ``seconds`` have passed and the last has returned: their
    records and (input set, answers)."""
    records, outs = [], []
    w0 = time.perf_counter()
    k = first
    while True:
        i = 1 + k % (len(prep.jts) - 1)
        t = time.perf_counter()
        outs.append((i, prep.entry.call(prep.jts[i])))
        _sync(device)
        records.append(CallRecord(t, time.perf_counter(), prep.tasks_of[i],
                                  *prep.launches_of[i]))
        k += 1
        if records[-1].end - w0 >= seconds:
            return records, outs, records[-1].end - w0


def non_finite(prep: Prepared, outs) -> int:
    """Lanes with an answer that is not a finite number."""
    failed = 0
    for _, o in outs:
        finite = np.ones(prep.shape, bool)
        for v in o.values():
            v = np.asarray(v, np.float64)
            finite &= np.isfinite(v.reshape(*prep.shape, -1)).all(axis=-1)
        failed += int((~finite).sum())
    return failed


def sampled_gaps(prep: Prepared, outs, seed: int,
                 precision: str = "float32") -> List[dict]:
    """The gaps of the seed's sample of lanes from the reference; with
    another ``precision`` the reference computed in it answers in the
    program's place (the control), on the same lanes."""
    cfg = prep.cell.config
    picks = check.sample(seed, len(outs), len(prep.lanes[0]),
                         int(prep.cell.traffic["check_lanes"]))
    per_lane = []
    for c, l in picks:
        i, o = outs[c]
        lane = prep.lanes[i][l]
        trace = prep.sets[i][lane.trace]
        want = check.reference(cfg, lane, trace)
        if precision == "float32":
            got = entries.lane_answers(o, prep.shape, l)
        else:
            got = {k: v for k, v in check.answers_of(check.reference(
                cfg, lane, trace, precision)).items() if k in o}
        per_lane.append(check.gaps(got, want))
    return per_lane


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: Optional[float] = None,
             out=None, err=None) -> int:
    """One run; prints the result line on ``out`` and returns the exit
    code."""
    out, err = out or sys.stdout, err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    prep = prepare(root, workload, seed, device)
    cell = prep.cell
    prep.entry.call(prep.jts[0])
    _sync(device)
    setup_s = time.perf_counter() - t0

    summary = None
    if trace:
        records, outs, summary = _traced(prep, int(cell.traffic["trace_calls"]),
                                         device)
        window_s = summary.window_s
    else:
        records, outs, window_s = timed_calls(prep, seconds, device)
    dev = device_info(device, cell.chips)
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)

    failed = non_finite(prep, outs)
    attempted = sum(r.lanes for r in records)
    t_check = time.perf_counter()
    per_lane = sampled_gaps(prep, outs, seed)
    found = check.widest(per_lane)
    correct = failed == 0 and check.judge(found, cell.limits)
    check_s = time.perf_counter() - t_check

    run = RunRecord(cell.name, setup_s, window_s, records, summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    secs = np.asarray([r.seconds for r in records])
    print(f"{cell.name}: seed {seed}, {len(records)} calls in "
          f"{window_s:.3f} s (call ms: median "
          f"{1e3 * float(np.median(secs)):.3f}, p95 "
          f"{1e3 * float(np.percentile(secs, 95)):.3f} over "
          f"{len(secs)} samples), set-up {setup_s:.3f} s, "
          f"{len(per_lane)} lanes checked in {check_s:.1f} s", file=err)
    if summary is not None:
        print(f"traced: {summary.calls} calls, device busy "
              f"{summary.busy_s:.6f} of {summary.window_s:.6f} s; "
              f"{len(summary.kernels)} kernels; card: {_power_limit()}",
              file=err)
    for k in cell.limits:
        print(f"check {k}: {found.get(k, math.nan):.6e} limit "
              f"{cell.limits[k]:.6e}", file=err)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}", file=err)
        return 3
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.gaps_by_label()}
    result["checks"] = {k: {"value": found.get(k), "limit": cell.limits[k]}
                        for k in cell.limits}
    print(json.dumps(result), file=out, flush=True)
    return 0
