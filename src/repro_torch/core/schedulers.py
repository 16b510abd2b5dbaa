"""Pluggable schedulers: MET, ETF, table-based (ILP), + registry.

Semantics follow DS3: a task is *assigned* to a PE's FIFO queue at the moment
it becomes ready (its decision epoch); the PE then executes its queue in
order.  The scheduler's job is to pick the PE.

* **MET** (Braun et al. '01): pick the PE whose *execution time* for the task
  is minimal — a naive view of system state ("only considering PEs with best
  execution times"); ties broken by earliest-available PE of that type.
* **ETF** (Blythe et al. '05): pick the PE with earliest *finish* time,
  accounting for the PE's current queue backlog AND the communication cost of
  moving the task's inputs from the PEs that produced them.
* **TableScheduler**: replays any offline schedule (e.g. an ILP solution)
  from a (application, task_id) -> pe_id lookup table.

New schedulers plug in via ``@register_scheduler("name")``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .applications import Application
from .resources import PE, ResourceDB, INF

# --------------------------------------------------------------------------
# Scheduler interface + registry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SchedContext:
    """Snapshot handed to the scheduler at a decision epoch."""
    now_us: float
    pe_free_us: np.ndarray            # (num_pes,) time each PE's queue drains
    # For the task being scheduled:
    app: Application
    task_id: int
    job_id: int
    pred_finish_us: np.ndarray        # (num_preds,) finish times of parents
    pred_pe: np.ndarray               # (num_preds,) PE ids of parents
    pred_bytes: np.ndarray            # (num_preds,) payload bytes
    freq_scale: np.ndarray            # (num_pes,) DVFS slowdown per PE
    available: Optional[np.ndarray] = None   # (num_pes,) False = failed PE


class Scheduler:
    name = "base"

    def pick_pe(self, db: ResourceDB, ctx: SchedContext) -> int:
        raise NotImplementedError

    def reset(self) -> None:  # called once per simulation
        pass


_REGISTRY: Dict[str, Callable[..., Scheduler]] = {}


def register_scheduler(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_scheduler(name: str, **kwargs) -> Scheduler:
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")


def available_schedulers() -> List[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------

def exec_times(db: ResourceDB, task_name: str, freq_scale: np.ndarray) -> np.ndarray:
    """(num_pes,) execution time of the task on each PE (INF = unsupported)."""
    out = np.full(db.num_pes, np.inf, dtype=np.float32)
    for j, pe in enumerate(db.pes):
        base = db.profiles.get(task_name, {}).get(pe.pe_type, INF)
        out[j] = base * (freq_scale[j] if pe.is_cpu else 1.0)
    return out


def ready_time_per_pe(db: ResourceDB, ctx: SchedContext) -> np.ndarray:
    """(num_pes,) earliest time the task's inputs can be present on each PE."""
    n = db.num_pes
    ready = np.full(n, ctx.now_us, dtype=np.float32)
    for k in range(len(ctx.pred_finish_us)):
        src = db.pes[int(ctx.pred_pe[k])]
        for j, pe in enumerate(db.pes):
            comm = db.comm.latency(float(ctx.pred_bytes[k]), src, pe)
            ready[j] = max(ready[j], float(ctx.pred_finish_us[k]) + comm)
    return ready


# --------------------------------------------------------------------------
# Built-in schedulers
# --------------------------------------------------------------------------

@register_scheduler("met")
class METScheduler(Scheduler):
    """Minimum Execution Time — naive: ignores queue state and comm cost.

    Canonical MET (Braun et al. '01): assign to the PE with minimum execution
    time *regardless of availability*; ties resolve to the first such PE, so
    load concentrates — exactly the paper's "naive representation of the
    system state" failure mode at high injection rates.
    """

    def pick_pe(self, db: ResourceDB, ctx: SchedContext) -> int:
        ex = exec_times(db, ctx.app.tasks[ctx.task_id].name, ctx.freq_scale)
        if ctx.available is not None:
            ex = np.where(ctx.available, ex, np.inf)
        return int(np.argmin(ex))


@register_scheduler("etf")
class ETFScheduler(Scheduler):
    """Earliest Task Finish — uses comm cost + live PE queue state."""

    def pick_pe(self, db: ResourceDB, ctx: SchedContext) -> int:
        ex = exec_times(db, ctx.app.tasks[ctx.task_id].name, ctx.freq_scale)
        ready = ready_time_per_pe(db, ctx)
        start = np.maximum(ready, ctx.pe_free_us.astype(np.float32))
        finish = start + ex
        if ctx.available is not None:
            finish = np.where(ctx.available, finish, np.inf)
        return int(np.argmin(finish))


@register_scheduler("table")
class TableScheduler(Scheduler):
    """Replay an offline (ILP) schedule: (app_name, task_id) -> pe id.

    When an application has several instances in flight the table maps each
    task to the *type-level* assignment computed for one job instance; among
    the PEs of that id's type we take the given id directly (static table, as
    in the paper: "optimal for one job instance").
    """

    def __init__(self, table: Mapping[Tuple[str, int], int]):
        self.table = dict(table)

    def pick_pe(self, db: ResourceDB, ctx: SchedContext) -> int:
        return int(self.table[(ctx.app.name, ctx.task_id)])


# --------------------------------------------------------------------------
# Offline ILP-style optimiser (exact, small DAGs): builds TableScheduler input
# --------------------------------------------------------------------------

def solve_optimal_table(db: ResourceDB, app: Application,
                        max_states: int = 2_000_000) -> Dict[Tuple[str, int], int]:
    """Exact minimum-makespan PE assignment for ONE job instance.

    Exhaustive branch-and-bound over task->PE assignments in topological
    order (the reference DAGs have ≤ 10 tasks, and identical PEs are
    symmetry-broken), mirroring the ILP table of the paper.

    Secondary objective (lexicographic): among equal-makespan optima,
    minimise the maximum per-PE busy time — an ILP solver free to pick any
    optimum would emit *some* spread assignment; taking the max-load-minimal
    one makes the table behave like a static pipeline when jobs interleave,
    which is the regime of paper Fig. 3.
    """
    T = app.num_tasks
    n = db.num_pes
    ex = db.latency_matrix(app.task_names)           # (T, n)
    preds = [t.predecessors for t in app.tasks]
    ebytes = app.edge_bytes_matrix()

    best = {"key": (np.inf, np.inf), "assign": None}

    pe_list = db.pes

    def comm(pbytes: float, src: int, dst: int) -> float:
        return db.comm.latency(pbytes, pe_list[src], pe_list[dst])

    def rec(i: int, assign: List[int], finish: List[float], pe_free: List[float],
            pe_load: List[float], states: List[int]):
        states[0] += 1
        if states[0] > max_states:
            return
        cur = (max(finish) if finish else 0.0, max(pe_load) if assign else 0.0)
        if cur >= best["key"]:
            return
        if i == T:
            best["key"] = cur
            best["assign"] = list(assign)
            return
        # symmetry breaking: among identical-state PEs of a type keep first
        seen_types = set()
        order = np.argsort(ex[i])
        for j in order:
            j = int(j)
            if not np.isfinite(ex[i, j]):
                continue
            key = (pe_list[j].pe_type, pe_free[j], pe_load[j])
            if key in seen_types:
                continue
            seen_types.add(key)
            ready = 0.0
            for p in preds[i]:
                ready = max(ready, finish[p] + comm(float(ebytes[i, p]), assign[p], j))
            start = max(ready, pe_free[j])
            f = start + float(ex[i, j])
            old_free, old_load = pe_free[j], pe_load[j]
            assign.append(j); finish.append(f)
            pe_free[j] = f; pe_load[j] = old_load + float(ex[i, j])
            rec(i + 1, assign, finish, pe_free, pe_load, states)
            assign.pop(); finish.pop(); pe_free[j] = old_free; pe_load[j] = old_load

    rec(0, [], [], [0.0] * n, [0.0] * n, [0])
    assert best["assign"] is not None, "optimal table search failed"
    return {(app.name, t): int(best["assign"][t]) for t in range(T)}
