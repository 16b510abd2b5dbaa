"""The DS3 simulation as a fixed-shape tensor program, on PyTorch.

The twin of ``src/repro/core/simkernel_jax.py`` under the ``met``, ``etf``
and ``table`` schedulers, for *static* DVFS governors (performance /
powersave / userspace: one OPP baked into the tables; :func:`simulate_torch`,
:func:`simulate_batch`) and for *dynamic* ones, the ondemand family with its
thermal throttle (:func:`simulate_torch_dtpm`, :func:`simulate_batch_dtpm`:
the DVFS and RC loop closed inside the scan, policies per lane).  Semantics
are the reference kernel's (same epoch ordering, same tie-breaking, float32
arithmetic).  Every entry point also takes ``faults``, fail-stop fail times
per PE (``+inf``: never), which runs the reference's fail-stop program
(DESIGN.md §14): an epoch that crosses a fail time rolls back the dead PE's
unfinished tasks and their committed descendants inside the scan, and the
schedulers route around dead PEs (not ``table``, which raises).

* :class:`SimTables` / :func:`build_tables` — one design's device-resident
  constants, built as the reference builds them (padding rules of DESIGN.md
  §5), or carried across from the JAX package's tables by
  :func:`tables_from_numpy`.
* The epoch scan is K1 (``kernels/epoch_scan.py``): on a CUDA tensor one
  launch of ``csrc/epoch_scan.cuh`` over all lanes, on a CPU tensor its plain
  version :func:`epoch_scan_plain`.  The batched entry points also take the
  tables of D designs stacked on a leading axis (``dse.batch.stack_tables``)
  with (D*S, J) lanes, design-major: lane l runs on design l // S.
* :func:`_epilogue` derives latency, energy and per-PE busy time from the
  scan's schedule (under DTPM the energy at each task's latched OPP), each
  sum a fixed tree per lane (:func:`tree_sum`); both routes share it, so
  they differ only in the scan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops as _ops
from ..kernels.epoch_scan import (epoch_scan_plain, lane_designs, per_design,
                                  tree_sum)
from ..obs import metrics as _metrics
from .applications import Application
from .dvfs import (Governor, MAX_OPP_LEVELS, PerformanceGovernor,
                   padded_ladder, policy_lanes)
from .power import active_power, idle_power
from .resources import NOMINAL_FREQ, ResourceDB
from . import thermal as _thermal

__all__ = ["SimTables", "build_tables", "tables_from_numpy",
           "epoch_scan_plain", "simulate_torch", "simulate_batch",
           "simulate_torch_dtpm", "simulate_batch_dtpm"]

# Frequency domains: one per SoC cluster (0=big, 1=LITTLE, 2=accelerator
# fabric).  Padded PE slots map to the last (accel) domain, which never moves
# and carries zero power — inert.
MIN_DOMAINS = 3

ARRAY_FIELDS = ("exec_us", "pred", "ebytes", "valid", "comm_mult",
                "comm_startup", "comm_inv_bw", "power_active", "power_idle",
                "table_pe", "node_of_pe", "pe_domain", "pe_is_cpu",
                "exec_opp", "power_active_opp", "opp_freq", "num_opp",
                "domain_node", "domain_cpu")
_DTYPES = {"pred": torch.bool, "valid": torch.bool, "table_pe": torch.int32,
           "node_of_pe": torch.int32, "pe_domain": torch.int32,
           "num_opp": torch.int32, "domain_node": torch.int32}


@dataclasses.dataclass(frozen=True, eq=False)
class SimTables:
    """One design's simulation constants (fields, shapes and dtypes of the
    reference's ``SimTables``).  Compared and hashed by identity: the kernel
    caches what it derives from a table set on the object."""
    exec_us: torch.Tensor        # (A, T, P) f32 — DVFS-scaled latency, 1e30=unsupported
    pred: torch.Tensor           # (A, T, T) bool
    ebytes: torch.Tensor         # (A, T, T) f32 (bytes flowing t' -> t)
    valid: torch.Tensor          # (A, T) bool
    comm_mult: torch.Tensor      # (P, P) f32 in {0,1,penalty}
    comm_startup: torch.Tensor   # () f32
    comm_inv_bw: torch.Tensor    # () f32
    power_active: torch.Tensor   # (P,) f32  W while busy
    power_idle: torch.Tensor     # (P,) f32  W while idle
    table_pe: torch.Tensor       # (A, T) i32 — table-scheduler assignment (or -1)
    node_of_pe: torch.Tensor     # (P,) i32 thermal node per PE slot
    pe_domain: torch.Tensor      # (P,) i32 frequency domain (cluster) per slot
    pe_is_cpu: torch.Tensor      # (P,) f32 1.0 = CPU slot (counts in util)
    # DTPM-only OPP tables (None for static-governor tables):
    exec_opp: Optional[torch.Tensor] = None          # (A, T, P, K) f32
    power_active_opp: Optional[torch.Tensor] = None  # (P, K) f32
    opp_freq: Optional[torch.Tensor] = None          # (C, K) f32 asc, top-padded
    num_opp: Optional[torch.Tensor] = None           # (C,) i32 real level count
    domain_node: Optional[torch.Tensor] = None       # (C,) i32 thermal node
    domain_cpu: Optional[torch.Tensor] = None        # (C,) f32 CPU PEs per domain
    t_max: int = 0
    num_pes: int = 0
    device: torch.device = torch.device("cpu")


def tables_from_numpy(fields, t_max: int, num_pes: int,
                      device="cuda") -> SimTables:
    """SimTables from numpy arrays: a mapping, or an object with the fields as
    attributes (the JAX package's tables after ``tree_map(np.asarray, tb)``).
    Absent or ``None`` OPP fields stay ``None``."""
    dev = resolve_device(device)
    get = (fields.get if isinstance(fields, Mapping)
           else lambda k: getattr(fields, k, None))
    kw = {}
    for name in ARRAY_FIELDS:
        value = get(name)
        if value is None:
            continue
        kw[name] = torch.as_tensor(
            np.array(value), dtype=_DTYPES.get(name, torch.float32),
            device=dev)
    return SimTables(t_max=int(t_max), num_pes=int(num_pes), device=dev, **kw)


def build_tables(db: ResourceDB, apps: Sequence[Application],
                 governor: Optional[Governor] = None,
                 table: Optional[Dict[Tuple[str, int], int]] = None,
                 pad_tasks: Optional[int] = None,
                 pad_pes: Optional[int] = None,
                 freq_caps: Optional[Mapping[str, float]] = None,
                 device="cuda") -> SimTables:
    """Build the simulation tables of one SoC design on ``device``.

    ``pad_tasks`` / ``pad_pes`` pad the task and PE axes to a fixed size so
    tables from *different* designs stack into one batch.  Padding is inert:
    padded task rows are invalid (pre-scheduled), padded PE columns carry
    1e30 latency (never win an argmin) and zero active/idle power.

    A *dynamic* governor (``governor.policy().dynamic``) additionally builds
    the OPP-indexed tables the DTPM scan gathers from (per-level latency
    ``exec_opp``, per-level active power, per-domain OPP ladders truncated at
    ``freq_caps``, which defaults to the governor's own).  The static scan
    refuses such tables; the DTPM scan reads them.
    """
    dev = resolve_device(device)
    governor = governor or PerformanceGovernor()
    dynamic = governor.policy().dynamic
    if freq_caps is None:
        freq_caps = getattr(governor, "freq_caps", None)
    A = len(apps)
    T = max(a.num_tasks for a in apps)
    P = db.num_pes
    if pad_tasks is not None:
        if pad_tasks < T:
            raise ValueError(f"pad_tasks={pad_tasks} < max tasks {T}")
        T = pad_tasks
    if pad_pes is not None:
        if pad_pes < P:
            raise ValueError(f"pad_pes={pad_pes} < num_pes {P}")
        P = pad_pes

    freq = {}
    for pe in db.pes:
        if pe.is_cpu and pe.cluster not in freq:
            freq[pe.cluster] = governor.initial_freq(pe.pe_type)

    exec_us = np.full((A, T, P), 1e30, dtype=np.float32)
    pred = np.zeros((A, T, T), dtype=bool)
    ebytes = np.zeros((A, T, T), dtype=np.float32)
    valid = np.zeros((A, T), dtype=bool)
    table_pe = np.full((A, T), -1, dtype=np.int32)

    for ai, app in enumerate(apps):
        lat = db.latency_matrix(app.task_names)      # (t, P), inf unsupported
        for t in range(app.num_tasks):
            valid[ai, t] = True
            for j, pe in enumerate(db.pes):
                base = lat[t, j]
                if np.isfinite(base):
                    scale = (NOMINAL_FREQ[pe.pe_type] / freq[pe.cluster]
                             if pe.is_cpu else 1.0)
                    # quantised as the reference does: f32(f32(base)·f32(scale))
                    exec_us[ai, t, j] = np.float32(np.float32(base) * np.float32(scale))
            if table is not None:
                table_pe[ai, t] = table.get((app.name, t), -1)
        pred[ai, :app.num_tasks, :app.num_tasks] = app.pred_matrix()
        ebytes[ai, :app.num_tasks, :app.num_tasks] = app.edge_bytes_matrix()

    comm_mult = np.zeros((P, P), dtype=np.float32)
    for s in range(db.num_pes):
        for d in range(db.num_pes):
            if s == d:
                continue
            comm_mult[s, d] = (db.comm.cross_cluster_penalty
                               if db.pes[s].cluster != db.pes[d].cluster else 1.0)

    p_act = np.zeros(P, dtype=np.float32)
    p_idle = np.zeros(P, dtype=np.float32)
    for j, pe in enumerate(db.pes):
        f = freq.get(pe.cluster, 0.0) if pe.is_cpu else 0.0
        p_act[j] = active_power(pe, f)
        p_idle[j] = idle_power(pe)

    # frequency-domain / thermal-node maps (padded slots are inert: zero
    # power, non-CPU, binned to the accel node/domain by convention)
    C = max(MIN_DOMAINS, max(pe.cluster for pe in db.pes) + 1)
    node_of_pe = np.full(P, _thermal.NODE_ACCEL, dtype=np.int32)
    node_of_pe[:db.num_pes] = _thermal.cluster_nodes(db)
    pe_domain = np.full(P, C - 1, dtype=np.int32)
    pe_is_cpu = np.zeros(P, dtype=np.float32)
    for j, pe in enumerate(db.pes):
        pe_domain[j] = pe.cluster
        pe_is_cpu[j] = 1.0 if pe.is_cpu else 0.0

    fields = dict(
        exec_us=exec_us, pred=pred, ebytes=ebytes, valid=valid,
        comm_mult=comm_mult,
        comm_startup=np.float32(db.comm.startup_us),
        # 1/bw taken in double precision, then rounded once, as the reference
        comm_inv_bw=np.float32(1.0 / db.comm.bw_bytes_per_us),
        power_active=p_act, power_idle=p_idle, table_pe=table_pe,
        node_of_pe=node_of_pe, pe_domain=pe_domain, pe_is_cpu=pe_is_cpu)
    if dynamic:
        fields.update(_build_opp_tables(db, apps, A, T, P, C, freq_caps))
    return tables_from_numpy(fields, T, P, dev)


def _build_opp_tables(db: ResourceDB, apps: Sequence[Application],
                      A: int, T: int, P: int, C: int,
                      freq_caps: Optional[Mapping[str, float]]) -> Dict:
    """The (…, K) OPP-indexed tables (numpy) the DTPM scan gathers from.

    Level ladders are ascending and top-padded by repeating the highest real
    level; ``num_opp`` bounds the real counts (truncated under ``freq_caps``,
    but never below one level).  ``exec_opp`` quantises exactly like the
    reference path — f32(base) · f32(nominal/f).
    """
    K = MAX_OPP_LEVELS
    exec_opp = np.full((A, T, P, K), 1e30, dtype=np.float32)
    p_act_opp = np.zeros((P, K), dtype=np.float32)
    opp_freq = np.zeros((C, K), dtype=np.float32)
    num_opp = np.ones(C, dtype=np.int32)
    domain_node = np.full(C, _thermal.NODE_ACCEL, dtype=np.int32)
    domain_cpu = np.zeros(C, dtype=np.float32)
    nodes = _thermal.cluster_nodes(db)
    ladders = {pe.pe_type: padded_ladder(pe.pe_type, freq_caps)
               for pe in db.pes if pe.is_cpu}

    for j, pe in enumerate(db.pes):
        if pe.is_cpu:
            _, row, n = ladders[pe.pe_type]
            c = pe.cluster
            num_opp[c] = n
            domain_node[c] = nodes[j]
            domain_cpu[c] += 1.0
            for k in range(K):
                opp_freq[c, k] = row[k]
                p_act_opp[j, k] = active_power(pe, row[k])
        else:
            p_act_opp[j, :] = active_power(pe, 0.0)

    for ai, app in enumerate(apps):
        lat = db.latency_matrix(app.task_names)
        for t in range(app.num_tasks):
            for j, pe in enumerate(db.pes):
                base = lat[t, j]
                if not np.isfinite(base):
                    continue
                if pe.is_cpu:
                    _, row, _ = ladders[pe.pe_type]
                    for k in range(K):
                        scale = np.float32(NOMINAL_FREQ[pe.pe_type] / row[k])
                        exec_opp[ai, t, j, k] = np.float32(
                            np.float32(base) * scale)
                else:
                    exec_opp[ai, t, j, :] = np.float32(base)

    return dict(exec_opp=exec_opp, power_active_opp=p_act_opp,
                opp_freq=opp_freq, num_opp=num_opp, domain_node=domain_node,
                domain_cpu=domain_cpu)


@_metrics.spanned(_metrics.EPILOGUE)
def _epilogue(tables: SimTables, arrival: torch.Tensor, app_idx: torch.Tensor,
              scheduled, start, finish, onpe,
              onopp=None) -> Dict[str, torch.Tensor]:
    """Latency, energy and per-PE busy time of (L, J, T) schedules: the
    reference's post-scan arithmetic (``simkernel_jax.py:533-571``), lanes
    first.  Every sum is a :func:`tree_sum` over the lane's own (J·T) cells,
    jobs or PEs, so a lane gets the same bits in any call: alone, in a sweep
    or in a chunk of one (XLA sums in its own order: tolerance in the
    tests); the schedule arrays pass through as they are.  ``onopp`` (DTPM)
    prices each task's busy time at its latched OPP's active power.  Each
    lane reads its own design's tables (stacked tables: lane l, design
    l // S)."""
    L = app_idx.shape[0]
    design = lane_designs(tables, L, app_idx.device)                    # (L,)
    valid_j = per_design(tables, "valid")[design[:, None], app_idx.long()]  # (L, J, T)
    busy = torch.where(valid_j, finish - start, 0.0)
    fin_valid = torch.where(valid_j, finish, 0.0)
    makespan = fin_valid.amax(dim=(1, 2))                               # (L,)
    job_finish = fin_valid.amax(dim=2)                                  # (L, J)
    avg_latency = tree_sum(job_finish - arrival) / job_finish.shape[1]
    # energy: active while busy + idle leakage elsewhere  (uJ = W * us).
    # busy · power of its PE is the reference's busy · onehot · power (the
    # one-hot factor is exactly 1 or 0); per-PE sums one PE at a time keep
    # memory at (L, J·T) without an (L, J·T, P) one-hot
    cell_pe = onpe.long().flatten(1)                                    # (L, J*T)
    if onopp is None:
        p_task = per_design(tables, "power_active")[design].gather(1, cell_pe)
    else:
        K = tables.power_active_opp.shape[-1]
        p_task = per_design(tables, "power_active_opp")[design].flatten(1) \
            .gather(1, cell_pe * K + onopp.long().flatten(1))
    busy_cells = busy.flatten(1)                                        # (L, J*T)
    e_active = tree_sum(busy_cells * p_task)
    busy_per_pe = torch.stack([tree_sum(torch.where(cell_pe == pe, busy_cells, 0.0))
                               for pe in range(tables.num_pes)], dim=1)  # (L, P)
    e_idle = tree_sum(per_design(tables, "power_idle")[design]
                      * torch.clamp(makespan[:, None] - busy_per_pe, min=0.0))
    energy_j = (e_active + e_idle) * 1e-6                               # W·us -> J
    return dict(finish=finish, start=start, onpe=onpe, scheduled=scheduled,
                job_finish=job_finish, makespan_us=makespan,
                avg_job_latency_us=avg_latency, energy_j=energy_j,
                busy_per_pe_us=busy_per_pe)


def _lanes(tables: SimTables, arrival, app_idx):
    """Lanes as f32 / int32 tensors on the tables' device (numpy accepted)."""
    def on_device(x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(tables.device, dtype)
    return on_device(arrival, torch.float32), on_device(app_idx, torch.int32)


def _plans(tables: SimTables, faults, L: int) -> Optional[torch.Tensor]:
    """Fail-time plans as (L, P) f32 on the tables' device: a (P,) plan
    shared by every lane or one (L, P) plan a lane; ``None`` stays ``None``
    (the fault-free program)."""
    if faults is None:
        return None
    if not isinstance(faults, torch.Tensor):
        faults = torch.from_numpy(np.asarray(faults, np.float32))
    faults = faults.to(tables.device, torch.float32)
    if faults.ndim == 1:
        faults = faults.expand(L, -1)
    if tuple(faults.shape) != (L, tables.num_pes):
        raise ValueError(f"faults {tuple(faults.shape)}: need ({tables.num_pes},)"
                         f" or ({L}, {tables.num_pes})")
    return faults.contiguous()


def _check_static(tables: SimTables):
    if tables.exec_opp is not None:
        # dynamic-built tables bake exec_us at the governor's initial (fmin)
        # OPP — the static scan would return plausible but wrong numbers
        raise ValueError("tables were built for a dynamic governor; run "
                         "them through simulate_torch_dtpm (DESIGN.md §7)")


def simulate_batch(tables: SimTables, policy: str, arrival, app_idx,
                   faults=None) -> Dict[str, torch.Tensor]:
    """Batched simulation: ``arrival`` / ``app_idx`` (L, J), one simulation
    per lane (seed × rate × mix; over stacked tables (D*S, J), design-major),
    in one K1 launch on a CUDA device.  Every
    output has the lane axis first.  ``faults``: a (P,) fail-time plan for
    every lane or an (L, P) one per lane; the output then gains ``steps``
    (L,), the scan steps a lane took, and ``commits`` (L,), the tasks it
    committed, re-commits included."""
    _check_static(tables)
    arrival, app_idx = _lanes(tables, arrival, app_idx)
    plans = _plans(tables, faults, int(arrival.shape[0]))
    scan = _ops.epoch_scan(tables, policy, arrival, app_idx, faults=plans)
    out = _epilogue(tables, arrival, app_idx, *scan[:4])
    if plans is not None:
        out.update(steps=scan[4][:, 0], commits=scan[4][:, 1])
    return out


def simulate_torch(tables: SimTables, policy: str, arrival, app_idx,
                   faults=None) -> Dict[str, torch.Tensor]:
    """Single simulation: ``arrival`` (J,) f32, ``app_idx`` (J,) int,
    ``faults`` a (P,) fail-time plan (the twin of ``simulate_jax(faults=)``).
    The output dict has the reference's keys and shapes."""
    arrival, app_idx = _lanes(tables, arrival, app_idx)
    out = simulate_batch(tables, policy, arrival[None], app_idx[None], faults)
    return {k: v[0] for k, v in out.items()}


def simulate_batch_dtpm(tables: SimTables, policy: str, arrival, app_idx,
                        gov, faults=None) -> Dict[str, torch.Tensor]:
    """Batched closed-loop DTPM simulation: ``arrival`` / ``app_idx`` (L, J)
    (over stacked tables (D*S, J), design-major), ``gov`` one dynamic
    ``GovernorPolicy`` for every lane, a sequence of L of them or
    ``PolicyLanes`` of L lanes (lanes with different policies share one K1
    launch).  The output
    dict gains ``onopp`` (L, J, T), the OPP index latched per task,
    ``opp_idx`` (L, C), each domain's final OPP, and ``peak_temp_c`` (L,), the
    peak of the inline RC loop.  ``faults`` as :func:`simulate_batch`'s."""
    arrival, app_idx = _lanes(tables, arrival, app_idx)
    L = int(arrival.shape[0])
    lanes = policy_lanes(gov, L)
    plans = _plans(tables, faults, L)
    scan = _ops.epoch_scan(tables, policy, arrival, app_idx, gov=lanes,
                           faults=plans)
    (scheduled, start, finish, onpe, onopp, opp_idx, peak) = scan[:7]
    out = _epilogue(tables, arrival, app_idx, scheduled, start, finish, onpe,
                    onopp)
    out.update(onopp=onopp, opp_idx=opp_idx, peak_temp_c=peak)
    if plans is not None:
        out.update(steps=scan[7][:, 0], commits=scan[7][:, 1])
    return out


def simulate_torch_dtpm(tables: SimTables, policy: str, arrival, app_idx,
                        gov, faults=None) -> Dict[str, torch.Tensor]:
    """Single closed-loop DTPM simulation under a dynamic governor policy
    (the twin of ``simulate_jax_dtpm``): windows advance lazily at decision
    epochs, then drain to the makespan so ``peak_temp_c`` covers the
    schedule's tail.  ``faults``: a (P,) fail-time plan."""
    arrival, app_idx = _lanes(tables, arrival, app_idx)
    out = simulate_batch_dtpm(tables, policy, arrival[None], app_idx[None],
                              [gov], faults)
    return {k: v[0] for k, v in out.items()}
