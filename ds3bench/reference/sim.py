"""The plain reference simulator: DS3's discrete-event loop over a heap of
decision epochs, one lane at a time, in plain Python and NumPy.

A frozen copy of the simulator's event-heap oracle (without telemetry,
which no cell of this benchmark drives) with its MET, ETF and
offline-table schedulers, fail-stop faults, the ondemand governor and the
RC thermal loop.  Semantics (DS3, arXiv:2003.09016, section 2):

* a task reaches its decision epoch when its job has arrived and every
  predecessor has been committed, at ``max(arrival, max finish of preds)``;
  epochs are taken in (ready, job, task) order;
* the scheduler picks a PE; the task joins that PE's FIFO queue:
  ``start = max(data ready on the PE, PE free)``, ``finish = start + exec``,
  data ready counting the transfer from each producer's PE;
* a CPU's latency scales with its cluster's clock, latched at the epoch;
* under ondemand, every sampling window each CPU cluster's utilisation
  sets its next clock, and the window's realised power advances the RC
  network by its exact update; the peak is the hottest node over the
  windows, drained to the makespan;
* a fail-stop fault ``(pe, fail_time_us)`` (the time rounded to float32;
  the last of a PE's wins) fires at the first decision epoch at or past
  its time, under any governor: every task committed to the dead PE that
  finishes after the fail time, and the committed descendants of those
  tasks, are rolled back; the closure's roots are ready no earlier than
  the fail time, the others wait for their predecessors again; the queues
  drain at the surviving finishes (recomputed only when a task was lost);
  MET and ETF never pick a dead PE.  The heap's entries are versioned
  ``(ready, job, task, version)`` and a stale pop is skipped, so a lane
  without faults is taken in the same order as before.  Rolled-back work
  is lost: the answers are those of the final schedule.

Every stored time is rounded to the run's precision (``precision.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import thermal
from .precision import rounding
from .soc import (NOMINAL_FREQ, OPP_TABLE, App, SoC, active_power,
                  capped_levels, idle_power)


@dataclasses.dataclass(frozen=True)
class Governor:
    """A static governor (``kind`` "performance": each cluster's top OPP;
    "design": the design's frequency caps) or ondemand (``up_threshold``,
    ``window_us``, the RC step ``thermal_dt_s``, the ladder capped at
    ``caps``)."""
    kind: str
    caps: Optional[Dict[str, float]] = None
    up_threshold: float = 0.8
    window_us: float = 50.0
    thermal_dt_s: Optional[float] = None

    @property
    def dynamic(self) -> bool:
        return self.kind == "ondemand"

    def initial_freq(self, pe_type: str) -> float:
        if self.kind == "performance":
            return OPP_TABLE[pe_type][-1][0]
        if self.kind == "design":
            return self.caps[pe_type]
        if self.kind == "ondemand":
            return capped_levels(pe_type, self.caps)[0]
        raise ValueError(f"unknown governor {self.kind!r}")

    def update(self, levels: Sequence[float], util, q) -> float:
        """Linux ondemand over a cluster's capped ladder ``levels``, in the
        run's precision ``q``: above the threshold the top level, else the
        lowest level at or above ``f_max * util / up_threshold`` (less a
        slack of 1e-9)."""
        up = q(self.up_threshold)
        if util > up:
            return levels[-1]
        target = q(q(q(levels[-1]) * q(max(util, 0.0))) / up)
        floor = q(target - q(1e-9))
        for f in levels:
            if q(f) >= floor:
                return f
        return levels[0]


@dataclasses.dataclass
class LaneResult:
    avg_latency_us: float
    makespan_us: float
    energy_j: float
    busy_per_pe_us: np.ndarray     # (P,)
    peak_temp_c: float
    records: List[list]
    # [job, task, pe, start, finish, freq GHz, active power W]


# --------------------------------------------------------------------------
# the offline table: exact minimum-makespan assignment of one job instance
# --------------------------------------------------------------------------

def _latency_matrix(soc: SoC, app: App) -> np.ndarray:
    return np.asarray([[soc.base_latency(t.name, pe) for pe in soc.pes]
                       for t in app.tasks], np.float32)


def _comm_us(soc: SoC, nbytes: float, src: int, dst: int) -> float:
    """The offline table's transfer time, in float64."""
    if src == dst:
        return 0.0
    c = soc.comm
    t = c.startup_us + nbytes / c.bw_bytes_per_us
    return t * c.multiplier(soc.pes[src], soc.pes[dst])


def _transfers(soc: SoC, q):
    """The simulator's transfer times, each step rounded as a stored time:
    ``multiplier x (startup + bytes x (1 / bandwidth))``, memoised on
    (bytes, source PE, destination PE)."""
    c, memo = soc.comm, {}
    startup, inv_bw = q(c.startup_us), q(1.0 / c.bw_bytes_per_us)

    def transfer(nbytes: float, src: int, dst: int):
        key = (nbytes, src, dst)
        t = memo.get(key)
        if t is None:
            mult = q(c.multiplier(soc.pes[src], soc.pes[dst]))
            t = memo[key] = q(mult * q(startup + q(q(nbytes) * inv_bw)))
        return t
    return transfer


def solve_table(soc: SoC, app: App,
                max_states: int = 2_000_000) -> Dict[Tuple[str, int], int]:
    """Branch and bound over task-to-PE assignments in topological order:
    least makespan of one job, then the least largest PE load; identical
    PEs with identical state are tried once."""
    T, ex = app.num_tasks, _latency_matrix(soc, app)
    preds = [t.predecessors for t in app.tasks]
    pes = soc.pes
    best = {"key": (math.inf, math.inf), "assign": None}

    def rec(i, assign, finish, pe_free, pe_load, states):
        states[0] += 1
        if states[0] > max_states:
            return
        cur = (max(finish) if finish else 0.0, max(pe_load) if assign else 0.0)
        if cur >= best["key"]:
            return
        if i == T:
            best["key"], best["assign"] = cur, list(assign)
            return
        seen = set()
        for j in np.argsort(ex[i]):
            j = int(j)
            if not np.isfinite(ex[i, j]):
                continue
            key = (pes[j].pe_type, pe_free[j], pe_load[j])
            if key in seen:
                continue
            seen.add(key)
            ready = 0.0
            for p in preds[i]:
                ready = max(ready, finish[p] + _comm_us(
                    soc, float(np.float32(app.tasks[p].out_bytes)),
                    assign[p], j))
            f = max(ready, pe_free[j]) + float(ex[i, j])
            old_free, old_load = pe_free[j], pe_load[j]
            assign.append(j)
            finish.append(f)
            pe_free[j], pe_load[j] = f, old_load + float(ex[i, j])
            rec(i + 1, assign, finish, pe_free, pe_load, states)
            assign.pop()
            finish.pop()
            pe_free[j], pe_load[j] = old_free, old_load

    rec(0, [], [], [0.0] * soc.num_pes, [0.0] * soc.num_pes, [0])
    if best["assign"] is None:
        raise RuntimeError(f"no table found for {app.name}")
    return {(app.name, t): int(best["assign"][t]) for t in range(T)}


# --------------------------------------------------------------------------
# one lane
# --------------------------------------------------------------------------

def _fail_times(faults: Sequence[Tuple[int, float]]) -> Dict[int, float]:
    """Each PE's fail time from ``(pe, fail_time_us)`` pairs, rounded to
    float32, the last of a PE's winning; times that never come (``inf``)
    are left out."""
    out: Dict[int, float] = {}
    for pe, t in faults:
        out[int(pe)] = float(np.float32(t))
    return {pe: t for pe, t in out.items() if math.isfinite(t)}


def simulate(soc: SoC, apps: Sequence[App], arrival_us: np.ndarray,
             app_index: np.ndarray, scheduler: str, governor: Governor,
             table: Optional[Dict[Tuple[str, int], int]] = None,
             bins: int = 32, repeats: int = 3,
             precision: str = "float32",
             faults: Sequence[Tuple[int, float]] = ()) -> LaneResult:
    """One lane: the schedule, its latency, energy, busy time per PE and
    peak temperature (the binned RC peak under a static governor, the
    in-loop RC peak under ondemand), under the fail-stop ``faults``
    (``(pe, fail_time_us)`` pairs)."""
    pending = _fail_times(faults)
    if pending and scheduler == "table":
        raise ValueError("fail-stop faults need a scheduler that routes "
                         "around a dead PE (met or etf), not the table")
    q, q_arr = rounding(precision)
    transfer = _transfers(soc, q)
    n = soc.num_pes
    pes = soc.pes
    pe_free = q_arr(np.zeros(n))
    clusters = sorted({pe.cluster for pe in pes if pe.is_cpu})
    cl_type = {c: next(pe.pe_type for pe in pes if pe.cluster == c)
               for c in clusters}
    cl_pes = {c: [pe.pe_id for pe in pes if pe.cluster == c]
              for c in clusters}
    freq = {c: governor.initial_freq(cl_type[c]) for c in clusters}
    cl_levels = {c: capped_levels(cl_type[c], governor.caps)
                 for c in clusters}
    base = {}           # (task name, pe) -> nominal latency
    for app in apps:
        for t in app.tasks:
            for pe in pes:
                base[t.name, pe.pe_id] = q(soc.base_latency(t.name, pe))

    exec_memo: Dict[Tuple, np.ndarray] = {}

    def exec_vec(name: str) -> np.ndarray:
        key = (name, *freq.values())
        hit = exec_memo.get(key)
        if hit is not None:
            return hit
        out = exec_memo[key] = np.full(n, np.inf, np.float32)
        for j, pe in enumerate(pes):
            b = base[name, j]
            if np.isfinite(b):
                scale = (q(NOMINAL_FREQ[pe.pe_type] / freq[pe.cluster])
                         if pe.is_cpu else np.float32(1.0))
                out[j] = q(b * scale)
        return out

    dynamic = governor.dynamic
    window = governor.window_us if dynamic else None
    next_end = window if dynamic else math.inf
    # each PE's records that may overlap a window, in queue (start) order
    queues = [collections.deque() for _ in range(n)]
    node_of_pe = thermal.cluster_nodes(soc)
    nodes = [int(x) for x in node_of_pe]
    p_idle = [idle_power(pe) for pe in pes]
    temps = np.full(4, thermal.T_AMBIENT_C)
    peak = thermal.T_AMBIENT_C
    if dynamic:
        dt_s = (governor.thermal_dt_s if governor.thermal_dt_s is not None
                else window * 1e-6)
        rc_a, rc_b = thermal.exact_step_matrices(dt_s)

    def advance(now: float) -> None:
        nonlocal next_end, temps, peak
        while dynamic and next_end <= now:
            w0, w1 = next_end - window, next_end
            busy = [0.0] * n
            power = [0.0] * thermal.NUM_NODES
            for queue in queues:
                for r in queue:
                    if r[3] >= w1:
                        break
                    # a task's share of the window, a stored time
                    ov = float(q(min(r[4], w1) - max(r[3], w0)))
                    if ov > 0.0:
                        busy[r[2]] += ov
                        power[nodes[r[2]]] += r[6] * ov / window
            for j in range(n):
                power[nodes[j]] += p_idle[j] * (
                    1.0 - min(max(busy[j] / window, 0.0), 1.0))
            new = {c: governor.update(cl_levels[c], q(q(sum(
                busy[j] for j in cl_pes[c])) / q(window * len(cl_pes[c]))), q)
                for c in clusters}
            temps = thermal.exact_step(temps, power, rc_a, rc_b)
            peak = max(peak, float(temps[:3].max()))
            freq.update(new)
            for queue in queues:
                while queue and queue[0][4] <= w1:
                    queue.popleft()
            next_end += window

    job_apps = [apps[int(a)] for a in app_index]
    children = {app.name: app.children() for app in apps}
    finish: Dict[Tuple[int, int], float] = {}
    on_pe: Dict[Tuple[int, int], int] = {}
    done_preds: Dict[Tuple[int, int], int] = {}
    # (ready, job, task, version): a rollback bumps the version of a task
    # whose entry it outdates; without faults each task is pushed once
    heap: List[Tuple[float, int, int, int]] = []
    version: Dict[Tuple[int, int], int] = {}

    def push(ready: float, jid: int, tid: int) -> None:
        v = version[jid, tid] = version.get((jid, tid), 0) + 1
        heapq.heappush(heap, (ready, jid, tid, v))

    for jid, app in enumerate(job_apps):
        for t in app.tasks:
            done_preds[jid, t.task_id] = 0
            if not t.predecessors:
                push(float(arrival_us[jid]), jid, t.task_id)

    dead = np.zeros(n, bool)

    def fail(pe_id: int, f_time: float) -> None:
        """PE ``pe_id`` dies at ``f_time``: its tasks that finish later and
        their committed descendants are rolled back and queued again."""
        dead[pe_id] = True
        lost = {(r[0], r[1]) for r in records
                if r[2] == pe_id and r[4] > f_time}
        grow = list(lost)
        while grow:
            jid, tid = grow.pop()
            for c in children[job_apps[jid].name][tid]:
                if (jid, c) in finish and (jid, c) not in lost:
                    lost.add((jid, c))
                    grow.append((jid, c))
        if not lost:
            return
        records[:] = [r for r in records if (r[0], r[1]) not in lost]
        for k, queue in enumerate(queues):
            queues[k] = collections.deque(
                r for r in queue if (r[0], r[1]) not in lost)
        for key in lost:
            del finish[key], on_pe[key]
        pe_free[:] = 0.0
        for r in records:
            pe_free[r[2]] = max(pe_free[r[2]], r[4])
        pe_free[pe_id] = np.inf
        for jid in {j for j, _ in lost}:
            for t in job_apps[jid].tasks:
                key = (jid, t.task_id)
                if key in finish:
                    continue
                preds = t.predecessors
                done_preds[key] = sum((jid, p) in finish for p in preds)
                if any((jid, p) in lost for p in preds):
                    version[key] = version.get(key, 0) + 1   # stale
                elif key in lost:          # a root: all its preds stand
                    push(max([float(arrival_us[jid]), f_time]
                             + [finish[jid, p] for p in preds]), jid,
                         t.task_id)

    records = []
    while heap:
        ready, jid, tid, ver = heapq.heappop(heap)
        if ver != version[jid, tid]:
            continue
        due = sorted((t, pe) for pe, t in pending.items() if t <= ready)
        for t, pe in due:
            del pending[pe]
            fail(pe, t)
        if due and ver != version[jid, tid]:
            continue                       # a pred of it was rolled back
        advance(ready)
        app = job_apps[jid]
        task = app.tasks[tid]
        ex = exec_vec(task.name)
        if dead.any():
            ex = np.where(dead, np.float32(np.inf), ex)
        preds = task.predecessors
        pf = [finish[jid, p] for p in preds]
        pp = [on_pe[jid, p] for p in preds]
        pb = [float(np.float32(app.tasks[p].out_bytes)) for p in preds]
        if scheduler == "met":
            pe_id = int(np.argmin(ex))
        elif scheduler == "etf":
            rdy = np.full(n, ready, np.float32)
            for k in range(len(preds)):
                for j in range(n):
                    rdy[j] = q(max(rdy[j], q(pf[k]) + transfer(pb[k], pp[k], j)))
            pe_id = int(np.argmin(q_arr(np.maximum(rdy, pe_free) + ex)))
        elif scheduler == "table":
            pe_id = int(table[app.name, tid])
        else:
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if not np.isfinite(ex[pe_id]):
            raise RuntimeError(f"{scheduler} chose a PE that cannot run "
                               f"{task.name}")
        data_ready = q(ready)
        for k in range(len(preds)):
            data_ready = max(data_ready, q(q(pf[k]) + transfer(
                pb[k], pp[k], pe_id)))
        start = max(q(data_ready), pe_free[pe_id])
        fin = q(start + ex[pe_id])
        pe_free[pe_id] = fin
        pe = pes[pe_id]
        f_ghz = freq[pe.cluster] if pe.is_cpu else 0.0
        rec = [jid, tid, pe_id, float(start), float(fin), f_ghz,
               active_power(pe, f_ghz)]
        records.append(rec)
        if dynamic:
            queues[pe_id].append(rec)
        finish[jid, tid] = float(fin)
        on_pe[jid, tid] = pe_id
        for c in children[app.name][tid]:
            done_preds[jid, c] += 1
            cpreds = app.tasks[c].predecessors
            if done_preds[jid, c] == len(cpreds):
                push(max(float(arrival_us[jid]),
                         max(finish[jid, p] for p in cpreds)), jid, c)

    job_finish = np.zeros(len(job_apps), np.float64)
    for r in records:
        job_finish[r[0]] = max(job_finish[r[0]], r[4])
    makespan = max((r[4] for r in records), default=0.0)
    busy = np.zeros(n)
    energy_uj = 0.0
    for r in records:
        dt = max(0.0, r[4] - r[3])
        busy[r[2]] += dt
        energy_uj += r[6] * dt
    for j, pe in enumerate(pes):
        energy_uj += idle_power(pe) * max(0.0, makespan - busy[j])
    if dynamic:
        while next_end - window < makespan:
            advance(next_end)
    else:
        p_act = np.asarray([active_power(pe, freq.get(pe.cluster, 0.0))
                            for pe in pes])
        p_idle = np.asarray([idle_power(pe) for pe in pes])
        peak = thermal.binned_peak(records, makespan, node_of_pe, p_act,
                                   p_idle, bins, repeats)
    lat = float(np.mean(job_finish - np.asarray(arrival_us, np.float64)))
    return LaneResult(lat, float(makespan), energy_uj * 1e-6, busy,
                      float(peak), records)
