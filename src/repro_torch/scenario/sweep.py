"""``sweep(scenario, axes={...})`` — cross-product scenario batches, on PyTorch.

The twin of ``src/repro/scenario/sweep.py``.  Any combination of scenario
axes — arrival rate × scheduler × design point × frequency cap × governor
policy × seed × fault set — is expanded into one batch.  Axes factorise into
the reference's kinds (DESIGN.md §9–10, §14):

* **design-affecting** (``design``, ``design.<field>``): each combination
  becomes a padded ``SimTables`` design of one stack (``repro_torch.dse.
  batch``'s inert-padding scheme: pad every design to the widest PE count,
  stack field by field);
* **policy** (``governor``, ``governor_params``): static governors bake into
  the tables and behave like design axes; *dynamic* (ondemand-family)
  governors become per-lane policies (``core.dvfs.stack_policies``) of
  K1's closed-loop DTPM variant, peak temperature from its inline RC loop;
* **trace-affecting** (``trace``, ``trace.<field>``, aliases ``rate`` /
  ``seed`` / ``jobs``): each combination becomes a stacked workload row;
* **faults** (``failures``, alias ``faults``): each value is one fail-stop
  fault set, stacked into ``(F, P)`` fail-time plans for K1's fail-stop
  variant; an all-no-op axis runs the fault-free program once and tiles it;
* **static** (``scheduler``): a branch of the kernel, swept in an outer
  python loop, one grid scan per value.

For one scheduler the whole (fault sets × designs × policies × traces)
cross-product runs as ONE epoch scan: one K1 launch of design-major lanes on
a CUDA device (the designs are K1's D axis, lane l reads design l // (F·G·S)),
or K1's plain version on the CPU.  Every lane equals a per-point
``run(..., backend="torch")``: the schedule and makespan bit for bit (padding
is inert; a lane of a launch equals a launch of that lane), the sums and the
RC peak within their reduction order.  ``backend="ref"`` sweeps the same
cross-product through the event-heap oracle lane by lane.

:data:`scan_calls` stands where the reference's ``compile_count`` stands: the
grid scans sweeps have started, keyed by program (DTPM, FAULTS) as
``kernels.epoch_scan.variant_launches`` is — one per scheduler value and
policy shape, on either device; lanes add none.  ``chunk=N`` streams the
lanes through the same programs in fixed-width chunks, and ``shard`` splits
each chunk over the lane devices (``shardexec``): one scan a block, blocks x
chunks a scheduler value.  ``telemetry=True`` replays each scan's lanes once,
after it (``obs.telemetry``), block by block under ``chunk=`` or ``shard``;
it starts no scan.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.dvfs import stack_policies
from ..core.jobgen import JobTrace
from ..dse.batch import (host_tensor, pad_node_map, simulate_grid,
                         stack_tables, stack_traces, to_design_major)
from ..dse.space import DesignPoint
from ..dse.thermal_torch import peak_temperature_grid
from ..obs import telemetry as _obs_tel
from ..sharding import lane_devices
from . import faults as _faults
from . import shardexec
from .config import Scenario, TraceSpec
from .errors import BackendCapabilityError, LaneAxisError, ScenarioError
from .result import SweepResult
from .run import run, tables_for

AXIS_ALIASES = {
    "rate": "trace.rate_jobs_per_ms",
    "seed": "trace.seed",
    "jobs": "trace.num_jobs",
    "faults": "failures",
}

_DESIGN_FIELDS = {f.name for f in dataclasses.fields(DesignPoint)}
_TRACE_FIELDS = {f.name for f in dataclasses.fields(TraceSpec)}

# grid scans started by sweep(), by program (DTPM, FAULTS); their sum stands
# where the reference's compile_count stands (one per scheduler value and
# policy shape, and per block under chunk= or shard; lanes add none)
scan_calls = dict.fromkeys(((False, False), (True, False), (False, True),
                            (True, True)), 0)


def _canon(name: str) -> str:
    return AXIS_ALIASES.get(name, name)


def _axis_kind(name: str) -> str:
    name = _canon(name)
    if name == "scheduler":
        return "static"
    if name == "failures":
        return "faults"
    if name in ("governor", "governor_params"):
        return "policy"
    if name == "design":
        return "design"
    if name.startswith("design."):
        field = name.split(".", 1)[1]
        if field not in _DESIGN_FIELDS:
            raise LaneAxisError(f"unknown design axis field {field!r}")
        return "design"
    if name == "trace":
        return "trace"
    if name.startswith("trace."):
        field = name.split(".", 1)[1]
        if field not in _TRACE_FIELDS:
            raise LaneAxisError(f"unknown trace axis field {field!r}")
        return "trace"
    raise LaneAxisError(
        f"unknown sweep axis {name!r}; use 'design', 'design.<field>', "
        f"'governor', 'governor_params', 'scheduler', 'trace', "
        f"'trace.<field>', 'failures' or aliases {sorted(AXIS_ALIASES)}")


def _apply_axes(scn: Scenario, names: Sequence[str],
                values: Sequence) -> Scenario:
    """Apply axis values to a scenario ('trace'-axis JobTraces excluded)."""
    for name, value in zip(names, values):
        name = _canon(name)
        if name == "trace" and isinstance(value, JobTrace):
            continue                       # materialised out-of-band
        scn = scn.replace(**{name: value})
    return scn


def _lane_trace(scn: Scenario, names: Sequence[str],
                values: Sequence) -> JobTrace:
    for name, value in zip(names, values):
        if _canon(name) == "trace" and isinstance(value, JobTrace):
            return value
    return scn.job_trace()


# The four grid programs, one per K1 instantiation: each starts ONE scan.

def _sweep_grid(tables, node_of_pe, arrival, app_idx, policy, bins, repeats):
    """Schedule simulation + thermal scan for (D, S) lanes."""
    scan_calls[False, False] += 1
    out = simulate_grid(tables, policy, arrival, app_idx)
    temps = peak_temperature_grid(out, node_of_pe, tables.power_active,
                                  tables.power_idle, bins=bins,
                                  repeats=repeats)
    return out, temps


def _sweep_grid_dtpm(tables, gov, arrival, app_idx, policy):
    """Closed-loop DTPM lanes: (D designs, G policies, S traces).  Peak
    temperature comes from the scan's inline RC loop (the one the throttle
    feedback integrates), so no post-hoc thermal scan."""
    scan_calls[True, False] += 1
    return simulate_grid(tables, policy, arrival, app_idx, gov=gov)


def _sweep_grid_faults(tables, node_of_pe, fplans, arrival, app_idx, policy,
                       bins, repeats):
    """Fail-stop lanes (F fault plans, D designs, S traces); the thermal
    scan takes the (F, D, S) grid with the designs' tables (DESIGN.md
    §14)."""
    scan_calls[False, True] += 1
    out = simulate_grid(tables, policy, arrival, app_idx, fplans=fplans)
    temps = peak_temperature_grid(out, node_of_pe, tables.power_active,
                                  tables.power_idle, bins=bins,
                                  repeats=repeats)
    return out, temps


def _sweep_grid_dtpm_faults(tables, gov, fplans, arrival, app_idx, policy):
    """Fail-stop DTPM lanes: (F fault plans, D designs, G policies,
    S traces) through the closed-loop program."""
    scan_calls[True, True] += 1
    return simulate_grid(tables, policy, arrival, app_idx, gov=gov,
                         fplans=fplans)


def _design_lanes(base: Scenario, design_axes: List[str],
                  combos: List[Tuple], pad_pes: Optional[int], device,
                  host: bool = False):
    """Padded+stacked tables and thermal-node map for the design lanes: each
    design's tables built (and cached) on the host, stacked, and moved to
    ``device`` once.  ``host=True`` keeps both stacks on the host (pinned
    for a CUDA ``device``): the chunked executor's streaming source."""
    scns = [_apply_axes(base, design_axes, c) for c in combos]
    dbs = [s.soc() for s in scns]
    P = max(db.num_pes for db in dbs)
    if pad_pes is not None:
        if pad_pes < P:
            raise ValueError(f"pad_pes={pad_pes} < widest design {P}")
        P = pad_pes
    tables = stack_tables([tables_for(s, pad_pes=P, device="cpu")
                           for s in scns], host=host, device=device)
    if host:
        return tables, host_tensor(pad_node_map(dbs, P, "cpu"), device)
    return tables, pad_node_map(dbs, P, device)


def sweep(scenario: Scenario, axes: Dict[str, Sequence],
          backend: str = "torch", device="cuda",
          pad_pes: Optional[int] = None, design_batch=None,
          telemetry: Optional[bool] = None, chunk: Optional[int] = None,
          shard: Optional[bool] = None) -> SweepResult:
    """Simulate the cross-product of ``axes`` around ``scenario``.

    ``axes`` maps axis names to value sequences; result arrays are shaped
    ``tuple(len(v) for v in axes.values())`` in dict order.  ``pad_pes``
    fixes the padded PE width; ``design_batch`` (a prebuilt
    ``repro_torch.dse.DesignBatch``) short-circuits table construction when
    the caller already stacked the design axis — it must correspond to a
    single ``"design"`` axis with matching points.

    ``backend="torch"`` (the default) runs one epoch scan per scheduler
    value on ``device`` (``"cuda"`` by default, which raises where there is
    no card; ``"cpu"`` runs K1's plain version).  ``backend="ref"`` runs
    the event-heap oracle lane by lane; ``device`` is not read.

    ``chunk=N`` (torch backend only, DESIGN.md §13) streams the design or
    policy lane axis through the same grid programs in fixed-width N-lane
    chunks from host-resident (pinned) stacks (``scenario.shardexec``):
    the device holds one chunk at a time, and every output equals the
    unchunked sweep's lane for lane.  ``shard`` splits each chunk (the
    whole lane axis without ``chunk``) into one contiguous block a lane
    device (``sharding.lane_devices(device)``: the process's CUDA cards,
    or ``device`` N times under ``sharding.virtual_lane_devices(N)``, a
    stream each): ``None`` (auto) and ``True`` shard exactly when there is
    more than one lane device, ``False`` never (``shardexec.resolve_mesh``);
    every output equals the unsharded sweep's bit for bit.

    ``telemetry`` (default: ``scenario.telemetry``) fills
    ``SweepResult.telemetry`` with one per-window
    :class:`~repro_torch.obs.telemetry.Telemetry` per lane (an object array
    shaped like the sweep), each equal to its point's ``run(...,
    telemetry=True)`` bit for bit.  The torch backend replays each scan's
    lanes in one batched replay over its outputs (per block, on the block's
    device, under ``chunk=`` or ``shard``); the simulations are not
    re-run.  Under a dynamic governor
    with faults it raises :class:`BackendCapabilityError`, as ``run`` does.
    """
    if not axes:
        raise ValueError("axes must name at least one swept dimension")
    if chunk is not None and (not isinstance(chunk, int) or chunk < 1):
        raise ValueError(f"chunk must be a positive lane count, got {chunk!r}")
    names = list(axes)
    values = {n: tuple(axes[n]) for n in names}
    if any(len(v) == 0 for v in values.values()):
        raise ValueError("every sweep axis needs at least one value")
    canon = [_canon(n) for n in names]
    if len(set(canon)) != len(canon):
        dups = sorted({c for c in canon if canon.count(c) > 1})
        raise ValueError(
            f"duplicate sweep axes after alias resolution: {dups} "
            f"(e.g. 'seed' and 'trace.seed' name the same field)")
    kinds = {n: _axis_kind(n) for n in names}
    static_axes = [n for n in names if kinds[n] == "static"]
    design_axes = [n for n in names if kinds[n] == "design"]
    policy_axes = [n for n in names if kinds[n] == "policy"]
    trace_axes = [n for n in names if kinds[n] == "trace"]
    # a whole-object axis would silently overwrite per-field axes of the
    # same object (duplicated lanes, no error) — reject the combination
    for whole in ("trace", "design"):
        fields = [n for n in names if _canon(n).startswith(whole + ".")]
        if whole in canon and fields:
            raise ValueError(
                f"axis '{whole}' conflicts with per-field axes {fields}: "
                f"a whole-'{whole}' value replaces the fields those axes set")

    want_tel = scenario.telemetry if telemetry is None else bool(telemetry)
    if backend == "ref":
        if chunk is not None or shard:
            raise BackendCapabilityError(
                "torch-backend lane options (chunk/shard)", "ref",
                "backend='torch'",
                detail="the ref backend runs lane by lane already")
        return _sweep_ref(scenario, names, values, want_tel)
    if backend != "torch":
        raise ScenarioError(f"unknown backend {backend!r}; have "
                            f"('ref', 'torch')")
    dev = resolve_device(device)
    mesh = shardexec.resolve_mesh(shard, lane_devices(dev))
    lane_exec = chunk is not None or mesh is not None

    # fault lanes: every value of a 'faults'/'failures' axis is one fault
    # set; with no such axis the base scenario's failures apply to all lanes
    fault_axes = [n for n in names if kinds[n] == "faults"]
    fault_sets = ([_faults.normalize_failures(v)
                   for v in values[fault_axes[0]]] if fault_axes
                  else [scenario.failures])
    have_faults = any(not f.is_noop for fs in fault_sets for f in fs)

    # classify the governor lanes by policy shape: static governors bake
    # into the tables (design-kind lanes), the dynamic ondemand family
    # becomes per-lane policies of the DTPM program
    policy_combos = list(itertools.product(
        *(values[n] for n in policy_axes))) or [()]
    pol_scns = [_apply_axes(scenario, policy_axes, c) for c in policy_combos]
    policies = [s.make_policy() for s in pol_scns]
    dyn_flags = {p.dynamic for p in policies}
    if len(dyn_flags) > 1:
        raise LaneAxisError(
            "a sweep cannot mix static and dynamic (ondemand-family) "
            "governors in one batch — they run different policy shapes; "
            "split the sweep per governor kind (DESIGN.md §10)")
    dynamic = dyn_flags.pop()
    if not dynamic:
        design_axes = design_axes + policy_axes   # baked into table lanes
        policy_axes = []
    if have_faults and dynamic and want_tel:
        raise BackendCapabilityError(
            "telemetry with faults under a dynamic governor", "torch",
            "backend='ref' (it records sampling windows in-loop)",
            detail="fail-stop rollback breaks the window-closure invariant "
                   "the post-hoc replay assumes")

    static_combos = list(itertools.product(
        *(values[n] for n in static_axes))) or [()]
    design_combos = list(itertools.product(
        *(values[n] for n in design_axes))) or [()]
    trace_combos = list(itertools.product(
        *(values[n] for n in trace_axes))) or [()]

    # workloads: one stacked (S, J) pair shared by every design lane
    t_scns = [_apply_axes(scenario, trace_axes, c) for c in trace_combos]
    traces = [_lane_trace(s, trace_axes, c)
              for s, c in zip(t_scns, trace_combos)]
    job_counts = {t.num_jobs for t in traces}
    if len(job_counts) > 1:
        raise LaneAxisError(
            f"the torch backend needs equal job counts per lane to stack one "
            f"(S, J) workload tensor, got {sorted(job_counts)}; sweep the "
            f"'jobs' axis with backend='ref' instead")
    arrival, app_idx = stack_traces(traces, dev)
    num_jobs = int(arrival.shape[1])

    # design-lane base: dynamic tables carry the OPP ladders, so the (first)
    # dynamic governor must be applied before tables are built; every dynamic
    # parameterisation shares the same tables (run._tables_key collapses them)
    lane_base = pol_scns[0] if dynamic else scenario

    if design_batch is not None:
        if design_axes != ["design"] or tuple(
                values["design"]) != design_batch.points:
            raise ValueError("design_batch requires a single 'design' axis "
                             "matching design_batch.points")
        if dynamic:
            if design_batch.tables.exec_opp is None:
                raise ValueError(
                    "design_batch tables lack the OPP ladders a dynamic "
                    "governor needs; build them with "
                    "build_design_batch(..., governor=<dynamic governor>)")
        elif design_batch.tables.exec_opp is not None:
            # dynamic-built tables bake exec_us at the ondemand initial
            # (fmin) OPP — running the static scan on them would silently
            # break the per-point run() equivalence contract
            raise ValueError(
                "design_batch was built for a dynamic governor; a static "
                "sweep needs build_design_batch(...) without one")
        elif scenario.governor != "design":
            # build_design_batch bakes each point's frequency-cap governor
            # into the tables; any other governor would silently diverge
            # from the per-point run() equivalence contract
            raise ValueError("design_batch tables pin the design frequency "
                             "caps; the scenario must use governor='design'")
        if int(design_batch.tables.exec_us.shape[1]) \
                != len(scenario.applications()):
            raise ValueError("design_batch was built for a different "
                             "application list than the scenario's")
        tables, node_of_pe = design_batch.tables, design_batch.node_of_pe
        if tables.device != dev:
            raise ValueError(f"design_batch lives on {tables.device}, the "
                             f"sweep runs on {dev}")

    # tables depend on the static (scheduler) axis only through the offline
    # ILP table — hoist the (D, …) stack out of the loop unless a swept
    # combo actually selects the "table" policy
    any_table = any(
        _apply_axes(lane_base, static_axes, sc).scheduler == "table"
        for sc in static_combos)
    if have_faults and any_table:
        raise BackendCapabilityError(
            "fail-stop injection with the 'table' scheduler", "torch",
            "backend='ref'",
            detail="the offline ILP table pins tasks to PEs, so dead-PE "
                   "fallback needs the runtime schedulers (met/etf)")
    rebuild_per_combo = design_batch is None and any_table
    if design_batch is None and not rebuild_per_combo:
        tables, node_of_pe = _design_lanes(lane_base, design_axes,
                                           design_combos, pad_pes, dev,
                                           host=lane_exec)

    gov_stack = stack_policies(policies) if dynamic else None

    # stacked (F, P) fault plans: pe_ids validate against the narrowest
    # design lane; plans are emitted at the padded PE width.  All-noop lanes
    # leave plans=None — the sweep then runs the fault-free program once and
    # tiles its results over the fault axis.
    plans = None
    if have_faults:
        min_pes = min(_apply_axes(lane_base, design_axes, c).design.num_pes
                      for c in design_combos)
        plans, _ = _faults.stack_fault_plans(
            fault_sets, min_pes, width=int(tables.num_pes))
        plans = torch.from_numpy(plans).to(dev)

    per_static = []
    for sc in static_combos:
        s_scn = _apply_axes(lane_base, static_axes, sc)
        if rebuild_per_combo:
            tables, node_of_pe = _design_lanes(s_scn, design_axes,
                                               design_combos, pad_pes, dev,
                                               host=lane_exec)
        replay = (_telemetry_replay(s_scn, design_axes, design_combos,
                                    app_idx, dynamic, plans is not None)
                  if want_tel else None)
        if dynamic:
            if lane_exec:
                out = shardexec.run_dtpm_grid(
                    tables, gov_stack, arrival, app_idx,
                    policy=s_scn.scheduler, chunk=chunk, mesh=mesh,
                    fplans=plans, telemetry=replay)
            elif plans is not None:
                out = _sweep_grid_dtpm_faults(tables, gov_stack, plans,
                                              arrival, app_idx,
                                              s_scn.scheduler)
            else:
                out = _sweep_grid_dtpm(tables, gov_stack, arrival, app_idx,
                                       s_scn.scheduler)
            temps = out["peak_temp_c"]
        elif lane_exec:
            out, temps = shardexec.run_static_grid(
                tables, node_of_pe, arrival, app_idx,
                policy=s_scn.scheduler, bins=s_scn.thermal.bins,
                repeats=s_scn.thermal.repeats, chunk=chunk, mesh=mesh,
                fplans=plans, telemetry=replay)
        elif plans is not None:
            out, temps = _sweep_grid_faults(
                tables, node_of_pe, plans, arrival, app_idx,
                s_scn.scheduler, bins=s_scn.thermal.bins,
                repeats=s_scn.thermal.repeats)
        else:
            out, temps = _sweep_grid(tables, node_of_pe, arrival, app_idx,
                                     s_scn.scheduler, bins=s_scn.thermal.bins,
                                     repeats=s_scn.thermal.repeats)
        tel = out.pop("telemetry", None)            # replayed block by block
        if replay is not None and not lane_exec:
            tel = replay(tables, out, gov_stack,
                         torch.arange(len(design_combos)))
        if plans is not None and not fault_axes:
            # base-scenario faults, no fault axis: drop the F=1 lane axis so
            # the grid keeps its fault-free shape
            out = {k: v[0] for k, v in out.items()}
            temps = temps[0]
            tel = None if tel is None else tel[0]
        entry = {name: out[key].double().cpu().numpy() for name, key in (
            ("avg_latency_us", "avg_job_latency_us"),
            ("makespan_us", "makespan_us"), ("energy_j", "energy_j"),
            ("busy_per_pe_us", "busy_per_pe_us"))}
        entry["peak_temp_c"] = temps.double().cpu().numpy()
        if tel is not None:
            entry["telemetry"] = tel
        if fault_axes and plans is None:
            # every fault lane is a no-op: the fault-free program ran once
            # and its results tile verbatim across the fault axis
            entry = {k: np.repeat(v[None], len(fault_sets), axis=0)
                     for k, v in entry.items()}
        per_static.append(entry)

    # assemble: (static..., faults..., design..., policy..., trace..., extra)
    # then the user's axes-dict order
    d_lens = [len(values[n]) for n in design_axes]
    p_lens = [len(values[n]) for n in policy_axes]
    t_lens = [len(values[n]) for n in trace_axes]
    s_lens = [len(values[n]) for n in static_axes]
    f_lens = [len(values[n]) for n in fault_axes]
    internal = static_axes + fault_axes + design_axes + policy_axes \
        + trace_axes
    perm = [internal.index(n) for n in names]
    # (Σstatic[, F], D[, G], S)
    grid_ndim = (4 if dynamic else 3) + (1 if fault_axes else 0)

    def _assemble(key: str) -> np.ndarray:
        stacked = np.stack([g[key] for g in per_static])
        extra = stacked.shape[grid_ndim:]
        arr = stacked.reshape(*s_lens, *f_lens, *d_lens, *p_lens, *t_lens,
                              *extra)
        k = len(internal)
        return np.transpose(arr, axes=perm + list(range(k, arr.ndim)))

    makespan = _assemble("makespan_us")
    return SweepResult(
        base=scenario, backend="torch", axes=values,
        avg_latency_us=_assemble("avg_latency_us"),
        throughput_jobs_per_ms=num_jobs / np.maximum(makespan, 1e-9) * 1e3,
        makespan_us=makespan, energy_j=_assemble("energy_j"),
        peak_temp_c=_assemble("peak_temp_c"),
        busy_per_pe_us=_assemble("busy_per_pe_us"),
        telemetry=_assemble("telemetry") if want_tel else None)


# the grid outputs a telemetry replay reads
_TEL_KEYS = ("scheduled", "start", "finish", "onpe", "onopp", "makespan_us")


def _telemetry_replay(s_scn: Scenario, design_axes: List[str],
                      design_combos: List[Tuple], app_idx: torch.Tensor,
                      dynamic: bool, faulted: bool):
    """The telemetry of one grid scan's lanes, as a callable ``(tables, out,
    gov, design_ids) -> object array`` shaped like the grid ((F,) D, (G,)
    S).  It puts the grid outputs back in K1's design-major lane order and
    replays every lane in one batched replay (``obs.telemetry``), so a
    lane's timeline is the one its ``run`` replays; ``design_ids`` (static
    only) are the indices of the tables' designs into ``design_combos``,
    whose governors give each design's frequency columns and window (a
    chunk of the streamed designs passes its own)."""
    if not dynamic:
        cols, windows = [], []
        for combo in design_combos:
            lane_scn = _apply_axes(s_scn, design_axes, combo)
            db, gov = lane_scn.soc(), lane_scn.make_governor()
            cols.append(_obs_tel.static_freq_columns(
                db, gov, _obs_tel.domain_count(db)))
            windows.append(_obs_tel.static_window(gov))

    def replay(tables, out, gov, design_ids) -> np.ndarray:
        lead = tuple(out["makespan_us"].shape)
        F = lead[0] if faulted else 1
        D, S = int(tables.exec_us.shape[0]), int(app_idx.shape[0])
        G = gov.lanes if dynamic else 1
        lanes = {k: to_design_major(v.reshape(F, D, G, S, *v.shape[len(lead):]))
                 for k, v in out.items() if k in _TEL_KEYS}
        apps = app_idx.to(tables.exec_us.device).repeat(D * F * G, 1)
        if dynamic:
            pick = torch.arange(D * F * G * S) // S % G
            tels = _obs_tel.torch_dtpm_telemetry(tables, gov.take(pick),
                                                 lanes, apps)
        else:
            ids = design_ids.tolist()
            tels = _obs_tel.torch_static_telemetry(
                tables, lanes, apps, [cols[i] for i in ids],
                [windows[i] for i in ids])
        grid = np.empty(len(tels), object)
        grid[:] = tels
        return np.moveaxis(grid.reshape(D, F, G, S), 0, 1).reshape(lead)

    return replay


def _sweep_ref(scenario: Scenario, names: List[str],
               values: Dict[str, Tuple],
               want_tel: bool = False) -> SweepResult:
    """Cross-product sweep through the reference kernel, lane by lane."""
    shape = tuple(len(values[n]) for n in names)
    lanes = list(itertools.product(*(values[n] for n in names)))
    results = []
    for combo in lanes:
        scn = _apply_axes(scenario, names, combo)
        trace = _lane_trace(scn, names, combo)
        results.append(run(scn, backend="ref", trace_override=trace,
                           telemetry=want_tel))
    P = max(r.utilization.shape[0] for r in results)
    busy = np.zeros((len(lanes), P), np.float64)
    for i, r in enumerate(results):
        busy[i, :r.utilization.shape[0]] = r.utilization * r.makespan_us

    def _arr(field):
        return np.asarray([getattr(r, field) for r in results],
                          np.float64).reshape(shape)

    tel = None
    if want_tel:
        tel = np.empty(len(lanes), object)
        tel[:] = [r.telemetry for r in results]
        tel = tel.reshape(shape)
    return SweepResult(
        base=scenario, backend="ref", axes=values,
        avg_latency_us=_arr("avg_latency_us"),
        throughput_jobs_per_ms=_arr("throughput_jobs_per_ms"),
        makespan_us=_arr("makespan_us"), energy_j=_arr("energy_j"),
        peak_temp_c=_arr("peak_temp_c"),
        busy_per_pe_us=busy.reshape(*shape, P),
        telemetry=tel)
