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
  scan's schedule (under DTPM at each task's latched OPP), each sum a fixed
  tree per lane: K7 (``kernels/epilogue.py``), one launch on a CUDA tensor,
  its plain version on a CPU tensor; both routes share it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels import epilogue as _k7
from ..kernels import ops as _ops
from ..kernels.epoch_scan import epoch_scan_plain
from ..obs import metrics as _metrics
from .applications import Application
from .dvfs import (Governor, MAX_OPP_LEVELS, PerformanceGovernor,
                   padded_ladder, policy_lanes)
from .power import active_power, idle_power
from .resources import INF, NOMINAL_FREQ, ResourceDB
from . import thermal as _thermal

__all__ = ["SimTables", "build_tables", "build_table_stack",
           "tables_from_numpy", "epoch_scan_plain", "simulate_torch",
           "simulate_batch", "simulate_torch_dtpm", "simulate_batch_dtpm"]

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
            np.array(value, order="C"),
            dtype=_DTYPES.get(name, torch.float32), device=dev)
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
    refuses such tables; the DTPM scan reads them.  One design's case of
    :func:`build_table_stack`.
    """
    fields, T, P = build_table_stack(
        [db], apps, [governor or PerformanceGovernor()], table=table,
        pad_tasks=pad_tasks, pad_pes=pad_pes, freq_caps=[freq_caps])
    return tables_from_numpy({k: v[0] for k, v in fields.items()}, T, P,
                             device)


def build_table_stack(dbs: Sequence[ResourceDB], apps: Sequence[Application],
                      governors: Sequence[Governor],
                      table: Optional[Dict[Tuple[str, int], int]] = None,
                      pad_tasks: Optional[int] = None,
                      pad_pes: Optional[int] = None,
                      freq_caps: Optional[Sequence[Optional[Mapping]]] = None):
    """``(fields, T, P)``: the (D, …) numpy stacks of ``ARRAY_FIELDS`` of D
    designs, design d under ``governors[d]`` (a dynamic one adds the OPP
    tables, ladders truncated at ``freq_caps[d]``, default the governor's).
    Latency and power are computed once a PE *kind* (profiles, type, cluster
    clock, ladder) and gathered into the slots, bit for bit as the reference
    builds each design (f32(f32(base) · f32(nominal / f)), 1e30 where a PE
    cannot run a task); padded slots are inert (DESIGN.md §5)."""
    D = len(dbs)
    # all static or all dynamic: a mix does not unpack (ValueError)
    (dynamic,) = {g.policy().dynamic for g in governors}
    A = len(apps)
    T = max(a.num_tasks for a in apps)
    P = max(db.num_pes for db in dbs)
    if pad_tasks is not None:
        if pad_tasks < T:
            raise ValueError(f"pad_tasks={pad_tasks} < max tasks {T}")
        T = pad_tasks
    if pad_pes is not None:
        if pad_pes < P:
            raise ValueError(f"pad_pes={pad_pes} < num_pes {P}")
        P = pad_pes

    # each design's PE list, read once: a kind and a cluster a slot; a
    # cluster runs at the governor's clock for its first CPU's type
    profiles, kinds, reps, kind_of, cluster_of = [], {}, [], [], []
    for db, gov, cap in zip(dbs, governors, freq_caps or [None] * D):
        cap = getattr(gov, "freq_caps", None) if cap is None else cap
        if db.profiles not in profiles:
            profiles.append(db.profiles)
        prof = profiles.index(db.profiles)
        freq = {}
        for pe in db.pes:
            f = top = None
            if pe.is_cpu:
                if pe.cluster not in freq:
                    freq[pe.cluster] = gov.initial_freq(pe.pe_type)
                f = freq[pe.cluster]
                top = cap.get(pe.pe_type) if dynamic and cap else None
            k = kinds.setdefault((prof, pe.pe_type, f, top), len(reps))
            if k == len(reps):
                reps.append(pe)
            kind_of.append(k)
            cluster_of.append(pe.cluster)
    NK = len(reps)                                   # kind NK: padding
    _metrics.counter(_metrics.DESIGNS_BUILT).inc(D)
    _metrics.counter(_metrics.PE_KINDS).inc(NK)

    K, big = MAX_OPP_LEVELS, np.float32(1e30)
    exec_k = np.full((NK + 1, A, T), big, np.float32)
    opp_k = np.full((NK + 1, A, T, K), big, np.float32)
    p_act, p_idle, is_cpu = np.zeros((3, NK + 1), np.float32)
    p_opp, ladder = np.zeros((NK + 1, K), np.float32), np.zeros((NK + 1, K))
    n_opp = np.ones(NK + 1, np.int32)
    node = np.full(NK + 1, _thermal.NODE_ACCEL, np.int32)
    node[:NK] = _thermal.cluster_nodes(ResourceDB(reps, {}))
    for k, ((prof, pe_type, f, top), pe) in enumerate(zip(kinds, reps)):
        base = np.full((A, T), np.inf, np.float32)
        for a, app in enumerate(apps):
            base[a, :app.num_tasks] = [profiles[prof].get(n, {}).get(
                pe_type, INF) for n in app.task_names]
        ok = np.isfinite(base)
        scale = NOMINAL_FREQ[pe_type] / f if pe.is_cpu else 1.0
        exec_k[k] = np.where(ok, base * np.float32(scale), big)
        p_act[k], p_idle[k] = active_power(pe, f or 0.0), idle_power(pe)
        is_cpu[k] = pe.is_cpu
        if dynamic and pe.is_cpu:
            _, row, n_opp[k] = padded_ladder(
                pe_type, None if top is None else {pe_type: top})
            scales = np.float32([NOMINAL_FREQ[pe_type] / r for r in row])
            opp_k[k] = np.where(ok[..., None], base[..., None] * scales, big)
            p_opp[k], ladder[k] = [active_power(pe, r) for r in row], row
        elif dynamic:
            opp_k[k], p_opp[k] = exec_k[k][..., None], p_act[k]

    # the kinds gathered into the slots; what no design changes broadcast
    real = np.arange(P) < np.asarray([db.num_pes for db in dbs])[:, None]
    kind, cluster = np.full((D, P), NK), np.full((D, P), -1)
    kind[real], cluster[real] = kind_of, cluster_of
    C = np.maximum(cluster.max(1) + 1, MIN_DOMAINS)        # (D,) domains
    valid = np.arange(T) < np.asarray([a.num_tasks for a in apps])[:, None]
    def stack(x):                     # one array for every design
        return np.broadcast_to(x, (D,) + x.shape)
    pred = np.zeros((A, T, T), dtype=bool)
    ebytes = np.zeros((A, T, T), dtype=np.float32)
    table_pe = np.full((A, T), -1, dtype=np.int32)
    for ai, app in enumerate(apps):
        n = app.num_tasks
        pred[ai, :n, :n] = app.pred_matrix()
        ebytes[ai, :n, :n] = app.edge_bytes_matrix()
        if table is not None:
            table_pe[ai, :n] = [table.get((app.name, t), -1) for t in range(n)]
    comm = np.float64([(db.comm.startup_us, db.comm.bw_bytes_per_us,
                        db.comm.cross_cluster_penalty) for db in dbs])
    pair = real[:, :, None] & real[:, None, :] & ~np.eye(P, dtype=bool)
    same = cluster[:, :, None] == cluster[:, None, :]
    fields = dict(
        exec_us=exec_k[kind].transpose(0, 2, 3, 1),
        pred=stack(pred), ebytes=stack(ebytes), valid=stack(valid),
        comm_mult=np.where(pair, np.where(same, 1.0, comm[:, 2, None, None]),
                           0.0).astype(np.float32),
        comm_startup=comm[:, 0].astype(np.float32),
        comm_inv_bw=(1.0 / comm[:, 1]).astype(np.float32),
        power_active=p_act[kind], power_idle=p_idle[kind],
        table_pe=stack(table_pe), node_of_pe=node[kind],
        pe_domain=np.where(real, cluster, C[:, None] - 1),
        pe_is_cpu=is_cpu[kind])
    if dynamic:
        if len(set(C)) != 1:
            raise ValueError("designs differ in frequency-domain count")
        # a domain's ladder and node are its last CPU's; no CPU: inert
        in_c = (is_cpu[kind] > 0)[..., None] \
            & (cluster[..., None] == np.arange(C[0]))           # (D, P, C)
        last = np.where(in_c, np.arange(P)[:, None], -1).max(1)  # (D, C)
        lk = np.where(last >= 0,
                      np.take_along_axis(kind, np.maximum(last, 0), 1), NK)
        fields.update(exec_opp=opp_k[kind].transpose(0, 2, 3, 1, 4),
                      power_active_opp=p_opp[kind], opp_freq=ladder[lk],
                      num_opp=n_opp[lk], domain_node=node[lk],
                      domain_cpu=in_c.sum(1).astype(np.float32))
    return fields, T, P


@_metrics.spanned(_metrics.EPILOGUE)
def _epilogue(tables: SimTables, arrival: torch.Tensor, app_idx: torch.Tensor,
              scheduled, start, finish, onpe,
              onopp=None) -> Dict[str, torch.Tensor]:
    """Latency, energy and per-PE busy time of (L, J, T) schedules: the
    reference's post-scan arithmetic (``simkernel_jax.py:533-571``), lanes
    first, as K7 (``kernels/epilogue.py``: one launch on a CUDA tensor, the
    plain version on a CPU tensor).  Every sum is a ``tree_sum`` over the
    lane's own (J·T) cells, jobs or PEs, so a lane gets the same bits in any
    call: alone, in a sweep or in a chunk of one (XLA sums in its own order:
    tolerance in the tests).  The schedule passes through; ``onopp`` (DTPM)
    prices each task at its latched OPP's active power.  Each lane reads its
    own design's tables (stacked tables: lane l, design l // S)."""
    return _k7.epilogue(tables, arrival, app_idx, scheduled, start, finish,
                        onpe, onopp)


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
