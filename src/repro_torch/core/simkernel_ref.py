"""Reference discrete-event simulation kernel (the oracle).

Semantics (DS3-style, matching the paper §2):

* The job generator injects application instances at given arrival times.
* A task reaches its *decision epoch* when its job has arrived and all its
  predecessors have been committed; the epoch time is
  ``max(arrival, max_p finish_p)`` (communication cost is accounted per
  candidate PE inside the scheduler, not in the epoch time).
* At each epoch the framework invokes the pluggable scheduler with the ready
  task; the scheduler picks a PE; the task enters that PE's FIFO queue:
  ``start = max(ready_on_pe(incl. comm), pe_free)``, ``finish = start + exec``.
* CPU execution time scales with the cluster's DVFS frequency (latched at
  task start); accelerators run at fixed clocks.
* Power/energy are integrated over the realised schedule; an optional
  ondemand governor updates cluster frequencies on sampling-window
  boundaries from measured utilisation.

Epoch ordering (and all tie-breaking) is deterministic:
(ready_time, job_id, task_id) — the epoch-scan kernel replicates it
bit-for-bit so the two kernels can be cross-validated.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .applications import Application
from .dvfs import Governor, PerformanceGovernor, capped_levels, throttle_index
from .jobgen import JobTrace
from .power import EnergyReport, active_power, energy_from_schedule, idle_power
from .resources import CPU_TYPES, NOMINAL_FREQ, PE, ResourceDB
from .schedulers import SchedContext, Scheduler
from . import thermal as _thermal


@dataclasses.dataclass
class TaskRecord:
    job_id: int
    task_id: int
    pe_id: int
    ready_us: float
    start_us: float
    finish_us: float
    freq_ghz: float


@dataclasses.dataclass
class SimResult:
    records: List[TaskRecord]
    job_arrival_us: np.ndarray
    job_finish_us: np.ndarray
    makespan_us: float
    energy: EnergyReport

    @property
    def avg_job_latency_us(self) -> float:
        return float(np.mean(self.job_finish_us - self.job_arrival_us))

    @property
    def throughput_jobs_per_ms(self) -> float:
        return len(self.job_finish_us) / max(self.makespan_us, 1e-9) * 1000.0

    def pe_utilization(self, db: ResourceDB) -> np.ndarray:
        busy = np.zeros(db.num_pes)
        for r in self.records:
            busy[r.pe_id] += r.finish_us - r.start_us
        return busy / max(self.makespan_us, 1e-9)


def _fail_times(failures) -> Dict[int, float]:
    """Per-PE fail time, last-wins.  Accepts ``(pe_id, fail_time_us)``
    pairs or ``repro_torch.scenario.FaultSpec`` objects (duck-typed on the
    ``pe_id`` attribute — core must not import the scenario facade)."""
    out: Dict[int, float] = {}
    for f in failures or []:
        if hasattr(f, "pe_id"):
            out[int(f.pe_id)] = float(f.fail_time_us)
        else:
            p, t = f
            out[int(p)] = float(t)
    return {p: t for p, t in out.items() if np.isfinite(t)}


def simulate(db: ResourceDB, apps: Sequence[Application], trace: JobTrace,
             scheduler: Scheduler, governor: Optional[Governor] = None,
             failures: Optional[Sequence[Tuple[int, float]]] = None,
             telemetry=None) -> SimResult:
    """Run one simulation; returns the full schedule + aggregate stats.

    ``failures``: optional fail-stop events — ``FaultSpec`` objects or bare
    ``(pe_id, fail_time_us)`` pairs — at fail time the PE dies permanently;
    tasks in flight or queued on it (and their already-committed
    descendants) are rolled back and re-scheduled on the surviving PEs.
    Models node loss the same way the pod-scale half handles preemption
    (checkpoint/restart): the work is lost, the workload still completes.

    ``telemetry``: optional per-window recorder (duck-typed, as
    ``repro_torch.obs.telemetry.TelemetryRecorder``).  Under a dynamic
    governor every sampling window's utilisation, post-transition frequency,
    realised node power and RC temperatures are recorded in-loop — the exact values
    the governor feedback integrated — and the windows are drained past the
    last decision epoch to the makespan (matching the epoch scan's tail
    drain).  Recording is observation-only: it adds a thermal read-out for
    uncapped governors but never feeds back into scheduling, so results are
    unchanged (asserted in tests/test_torch_obs.py).
    """
    governor = governor or PerformanceGovernor()
    scheduler.reset()

    n_pes = db.num_pes
    pe_free = np.zeros(n_pes, dtype=np.float32)
    fail_at = _fail_times(failures)
    failed: set = set()

    # cluster DVFS state (cluster id -> freq); accelerators fixed
    clusters = sorted({pe.cluster for pe in db.pes if pe.is_cpu})
    cl_type = {c: next(pe.pe_type for pe in db.pes if pe.cluster == c and pe.is_cpu)
               for c in clusters}
    freq = {c: governor.initial_freq(cl_type[c]) for c in clusters}

    def freq_scale_vec() -> np.ndarray:
        out = np.ones(n_pes, dtype=np.float32)
        for j, pe in enumerate(db.pes):
            if pe.is_cpu:
                out[j] = NOMINAL_FREQ[pe.pe_type] / freq[pe.cluster]
        return out

    # ondemand / DTPM bookkeeping — semantics shared with the epoch scan via
    # the array-form GovernorPolicy (governor.update delegates to
    # dvfs.ondemand_index; the throttle calls dvfs.throttle_index)
    pol = governor.policy()
    window_us = (pol.sample_window_us if pol.dynamic
                 else getattr(governor, "sample_window_us", None))
    next_window_end = window_us if window_us else np.inf
    committed: List[TaskRecord] = []

    throttle = pol.dynamic and np.isfinite(pol.thermal_cap_c)
    recording = telemetry is not None and pol.dynamic and window_us
    caps = getattr(governor, "freq_caps", None)
    # loop invariants of the per-window scans, hoisted: CPU PEs per cluster,
    # capped OPP ladders, thermal node maps.  Recording needs the thermal
    # read-out (and the ladders, for frequency indices) even when no cap is
    # set — the DTPM carry in the epoch scan always integrates it.
    cl_pes = {c: [pe.pe_id for pe in db.pes
                  if pe.cluster == c and pe.is_cpu] for c in clusters}
    if throttle or recording:
        rc_ab = _thermal.exact_step_matrices(pol.thermal_dt_s)
        temps = np.full(4, _thermal.T_AMBIENT_C)
        node_of_pe = _thermal.cluster_nodes(db)
        cl_node = {c: int(node_of_pe[cl_pes[c][0]]) for c in clusters}
        cl_opps = {c: capped_levels(cl_type[c], caps) for c in clusters}

    def window_util(cluster: int, w0: float, w1: float) -> float:
        pes_in = cl_pes[cluster]
        busy = 0.0
        for r in committed:
            if r.pe_id in pes_in:
                busy += max(0.0, min(r.finish_us, w1) - max(r.start_us, w0))
        return busy / max((w1 - w0) * len(pes_in), 1e-9)

    def window_node_power(w0: float, w1: float) -> np.ndarray:
        """Realised per-thermal-node power (W) over one sampling window:
        active at each task's latched frequency, idle leakage elsewhere."""
        p = np.zeros(_thermal.NUM_NODES)
        busy = np.zeros(n_pes)
        width = w1 - w0
        for r in committed:
            ov = max(0.0, min(r.finish_us, w1) - max(r.start_us, w0))
            if ov <= 0.0:
                continue
            pe = db.pes[r.pe_id]
            p[node_of_pe[r.pe_id]] += active_power(pe, r.freq_ghz) * ov / width
            busy[r.pe_id] += ov
        for j, pe in enumerate(db.pes):
            idle_frac = 1.0 - min(max(busy[j] / width, 0.0), 1.0)
            p[node_of_pe[j]] += idle_power(pe) * idle_frac
        return p

    def nearest_level(cluster: int, f: float) -> int:
        # nearest-level handoff (update() returns a ladder entry)
        opps = cl_opps[cluster]
        return min(range(len(opps)), key=lambda i: abs(opps[i] - f))

    def advance_windows(now: float) -> None:
        nonlocal next_window_end, temps
        while window_us and next_window_end <= now:
            w0 = next_window_end - window_us
            new_freq = {}
            util = {}
            for c in clusters:
                util[c] = window_util(c, w0, next_window_end)
                new_freq[c] = governor.update(cl_type[c], freq[c], util[c])
            if throttle or recording:
                p = window_node_power(w0, next_window_end)
                temps = _thermal.exact_step(temps, p, *rc_ab)
            if throttle:
                for c in clusters:
                    cur = nearest_level(c, new_freq[c])
                    idx = throttle_index(
                        np.asarray([cur]),
                        np.asarray([temps[cl_node[c]]]), pol.thermal_cap_c)
                    new_freq[c] = cl_opps[c][int(idx[0])]
            freq.update(new_freq)
            if recording:
                telemetry.on_window(
                    next_window_end, util, dict(freq),
                    {c: nearest_level(c, freq[c]) for c in clusters},
                    p, temps)
            # records drained before this boundary can never overlap a later
            # window — prune so the scans stay O(in-flight), not O(history)
            committed[:] = [r for r in committed
                            if r.finish_us > next_window_end]
            next_window_end += window_us

    # per-job task state
    num_jobs = trace.num_jobs
    job_apps = [apps[int(a)] for a in trace.app_index]
    finish: Dict[Tuple[int, int], float] = {}
    on_pe: Dict[Tuple[int, int], int] = {}
    n_done_preds: Dict[Tuple[int, int], int] = {}

    # heap entries carry a per-task version stamp: fault rollback can leave
    # stale entries whose (ready, …) key no longer reflects the re-simulated
    # predecessor finishes — bumping the version at invalidation makes them
    # skip cleanly at pop (without faults each task is pushed exactly once,
    # so versioning never changes fault-free behaviour)
    heap: List[Tuple[float, int, int, int]] = []   # (ready, job, task, ver)
    entry_ver: Dict[Tuple[int, int], int] = {}

    def push_epoch(ready_us: float, jid2: int, tid2: int) -> None:
        ver = entry_ver.get((jid2, tid2), 0) + 1
        entry_ver[(jid2, tid2)] = ver
        heapq.heappush(heap, (ready_us, jid2, tid2, ver))

    for jid in range(num_jobs):
        app = job_apps[jid]
        for t in app.tasks:
            n_done_preds[(jid, t.task_id)] = 0
            if not t.predecessors:
                push_epoch(float(trace.arrival_us[jid]), jid, t.task_id)

    def apply_failure(pe_id: int, f_time: float) -> None:
        """Fail-stop ``pe_id`` at ``f_time``: roll back its unfinished tasks
        and (transitively) their committed descendants, re-enqueue them."""
        failed.add(pe_id)
        invalid = {(r.job_id, r.task_id) for r in records
                   if r.pe_id == pe_id and r.finish_us > f_time}
        changed = True
        while changed:          # descendants of invalidated tasks
            changed = False
            for r in records:
                key = (r.job_id, r.task_id)
                if key in invalid:
                    continue
                preds_r = job_apps[r.job_id].tasks[r.task_id].predecessors
                if any((r.job_id, p) in invalid for p in preds_r):
                    invalid.add(key)
                    changed = True
        if not invalid:
            return
        records[:] = [r for r in records if (r.job_id, r.task_id) not in invalid]
        committed[:] = [r for r in committed
                        if (r.job_id, r.task_id) not in invalid]
        for key in invalid:
            finish.pop(key, None)
            on_pe.pop(key, None)
        # recompute queue drain times from the surviving schedule
        pe_free[:] = 0.0
        for r in records:
            pe_free[r.pe_id] = max(pe_free[r.pe_id], r.finish_us)
        pe_free[pe_id] = np.float32(np.inf)
        # reset dependency counters so pred re-completion re-unlocks children
        # (also for PENDING tasks whose pred got invalidated: their heap
        # entries are version-stale — skipped at pop, re-pushed via unlock)
        for jid2 in range(num_jobs):
            for t2 in job_apps[jid2].tasks:
                key2 = (jid2, t2.task_id)
                if key2 in finish:
                    continue
                n_done_preds[key2] = sum(
                    1 for p in t2.predecessors if (jid2, p) in finish)
                if any((jid2, p) in invalid for p in t2.predecessors):
                    entry_ver[key2] = entry_ver.get(key2, 0) + 1
        # re-enqueue invalidated tasks whose preds are all still committed
        for jid2, tid2 in invalid:
            app2 = job_apps[jid2]
            preds2 = app2.tasks[tid2].predecessors
            if all((jid2, p) in finish for p in preds2):
                r2 = max([float(trace.arrival_us[jid2]), f_time]
                         + [finish[(jid2, p)] for p in preds2])
                push_epoch(r2, jid2, tid2)

    records: List[TaskRecord] = []
    while heap:
        ready, jid, tid, ver = heapq.heappop(heap)
        # trigger any fail-stop events that precede this epoch
        for pe_id, f_time in sorted(fail_at.items(), key=lambda kv: kv[1]):
            if pe_id not in failed and f_time <= ready:
                apply_failure(pe_id, f_time)
        app = job_apps[jid]
        task = app.tasks[tid]
        if ver != entry_ver.get((jid, tid)):
            continue                      # superseded by a rollback re-push
        if (jid, tid) in finish:          # re-queued duplicate after rollback
            continue
        if any((jid, p) not in finish for p in task.predecessors):
            continue                      # stale entry: pred was rolled back
        advance_windows(ready)
        fs = freq_scale_vec()

        preds = task.predecessors
        ctx = SchedContext(
            now_us=ready,
            pe_free_us=pe_free.copy(),
            app=app, task_id=tid, job_id=jid,
            pred_finish_us=np.array([finish[(jid, p)] for p in preds], dtype=np.float32),
            pred_pe=np.array([on_pe[(jid, p)] for p in preds], dtype=np.int32),
            pred_bytes=np.array([app.tasks[p].out_bytes for p in preds], dtype=np.float32),
            freq_scale=fs,
            available=np.array([j not in failed for j in range(n_pes)]),
        )
        pe_id = scheduler.pick_pe(db, ctx)
        pe = db.pes[pe_id]

        # data-ready time on the chosen PE (comm from producer PEs)
        data_ready = np.float32(ready)
        for k, p in enumerate(preds):
            src = db.pes[int(ctx.pred_pe[k])]
            comm = db.comm.latency(float(ctx.pred_bytes[k]), src, pe)
            data_ready = max(data_ready, np.float32(ctx.pred_finish_us[k] + np.float32(comm)))

        exec_us = db.latency(task.name, pe, float(fs[pe_id]))
        assert np.isfinite(exec_us), \
            f"scheduler chose unsupported PE {pe.name} for task {task.name}"
        start = max(np.float32(data_ready), pe_free[pe_id])
        fin = np.float32(start + np.float32(exec_us))
        pe_free[pe_id] = fin

        f_ghz = freq[pe.cluster] if pe.is_cpu else 0.0
        rec = TaskRecord(jid, tid, pe_id, float(ready), float(start), float(fin),
                         float(f_ghz))
        records.append(rec)
        committed.append(rec)
        finish[(jid, tid)] = float(fin)
        on_pe[(jid, tid)] = pe_id

        # unlock children
        for child in app.tasks:
            if tid in child.predecessors:
                key = (jid, child.task_id)
                n_done_preds[key] += 1
                if n_done_preds[key] == len(child.predecessors):
                    r = max(float(trace.arrival_us[jid]),
                            max(finish[(jid, p)] for p in child.predecessors))
                    push_epoch(r, jid, child.task_id)

    job_finish = np.zeros(num_jobs, dtype=np.float32)
    for r in records:
        job_finish[r.job_id] = max(job_finish[r.job_id], r.finish_us)
    makespan = float(max((r.finish_us for r in records), default=0.0))
    if recording:
        # drain the windows between the last decision epoch and the makespan
        # (mirroring the epoch scan's post-scan drain): the timeline covers
        # the execution tail, including the final partial window
        while next_window_end - window_us < makespan:
            advance_windows(next_window_end)
    intervals = [(r.pe_id, r.start_us, r.finish_us,
                  r.freq_ghz if db.pes[r.pe_id].is_cpu else 0.0) for r in records]
    energy = energy_from_schedule(db, intervals, makespan)
    return SimResult(records, trace.arrival_us.copy(), job_finish, makespan, energy)
