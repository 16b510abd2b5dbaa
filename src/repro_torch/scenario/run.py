"""``run(scenario, backend=...)`` — one scenario, either kernel.

``backend="torch"`` (the default) builds the scenario's ``SimTables`` on the
device and runs the epoch scan (K1 on a CUDA device, its plain version on the
CPU): for a static governor with the binned RC peak temperature, for a
dynamic one (ondemand, throttle) as the closed DTPM loop whose inline RC
network gives the peak temperature, and under either with the scenario's
fail-stop faults rolled back inside the scan; ``backend="ref"`` materialises
the scenario and calls the port's event-heap oracle.  Tables are cached on the
(frozen, hashable) scenario minus its trace, and on the device, so repeated
runs over different workloads reuse them.

Unlike the reference's ``run``, which defaults to ``"ref"``, this one runs on
the card unless asked otherwise: ``device="cuda"`` raises where there is no
CUDA device; pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import simkernel_ref as _refk
from ..core import simkernel_torch as _torchk
from ..core.simkernel_torch import SimTables
from ..core.thermal import cluster_nodes
from ..dse import thermal_torch as _thermal_torch
from . import faults as _faults
from .config import Scenario, ThermalSpec, TraceSpec
from .errors import BackendCapabilityError, ScenarioError
from .result import Result

BACKENDS = ("ref", "torch")


def _tables_key(scn: Scenario) -> Scenario:
    """Strip table-irrelevant fields so different workloads share tables.

    The scheduler only shapes tables through the offline ILP table, so all
    non-"table" policies collapse to one cache entry per design/governor.
    Dynamic (ondemand-family) governors collapse further: their OPP ladders
    depend on the design and applications alone.
    """
    scheduler = scn.scheduler if scn.scheduler == "table" else "etf"
    key = dataclasses.replace(scn, trace=TraceSpec(), failures=(),
                              thermal=ThermalSpec(), scheduler=scheduler,
                              telemetry=False)
    if key.make_policy().dynamic:
        key = dataclasses.replace(key, governor="ondemand",
                                  governor_params=())
    return key


@functools.lru_cache(maxsize=256)
def _cached_tables(key: Scenario, pad_pes: Optional[int],
                   device: torch.device) -> SimTables:
    return _torchk.build_tables(key.soc(), key.applications(),
                                governor=key.make_governor(),
                                table=key.schedule_table(), pad_pes=pad_pes,
                                device=device)


def tables_for(scn: Scenario, pad_pes: Optional[int] = None,
               device="cuda") -> SimTables:
    """The scenario's ``SimTables`` on ``device`` (identical to a direct
    ``build_tables`` call), cached across traces and thermal settings."""
    return _cached_tables(_tables_key(scn), pad_pes, resolve_device(device))


@functools.lru_cache(maxsize=256)
def _cached_nodes(design, device: torch.device) -> torch.Tensor:
    """Thermal node per PE for a design (depends on the design alone)."""
    return torch.as_tensor(np.asarray(cluster_nodes(design.to_db()), np.int32),
                           device=device)


def _peak_temp_single(out, nodes, p_act, p_idle, bins: int, repeats: int):
    """One schedule's RC peak temperature: ``peak_temperature_grid`` at one
    lane, the code path of every lane of a ``sweep``."""
    one = {k: out[k][None, None] for k in ("start", "finish", "onpe",
                                           "scheduled", "makespan_us")}
    return _thermal_torch.peak_temperature_grid(
        one, nodes[None], p_act[None], p_idle[None], bins=bins,
        repeats=repeats)[0, 0]


def run(scenario: Scenario, backend: str = "torch", *, device="cuda",
        trace_override=None, telemetry: Optional[bool] = None) -> Result:
    """Simulate one scenario.

    ``backend="torch"``: the epoch scan on ``device`` under met, etf or
    table, for every governor: static ones (performance / powersave /
    userspace / ``"design"``) bake one OPP into the tables and report the
    binned RC co-simulation's peak temperature; the ondemand family runs the
    closed DTPM loop inside the scan and reports the peak temperature of its
    inline RC feedback.  ``scenario.failures`` run as the reference's
    fail-stop program under met and etf, static or dynamic (a spec that can
    never fire takes the fault-free program); with the ``table`` scheduler
    they raise :class:`BackendCapabilityError`, as in the reference.
    Telemetry raises :class:`BackendCapabilityError` (a later slice).
    ``backend="ref"``: the event-heap reference kernel on the host — all
    governors and fail-stop injection; ``device`` is not read.

    ``trace_override``: a pre-materialised ``JobTrace`` replacing the
    scenario's trace spec.
    """
    want_tel = scenario.telemetry if telemetry is None else bool(telemetry)
    if backend not in BACKENDS:
        raise ScenarioError(f"unknown backend {backend!r}; have {BACKENDS}")
    if want_tel:
        raise BackendCapabilityError(
            "telemetry", backend, "repro.scenario.run",
            detail="per-window timelines need repro_torch.obs, which is not "
                   "ported yet (ROADMAP.md queue 1, item 9)")

    if backend == "ref":
        db = scenario.soc()
        res = _refk.simulate(db, scenario.applications(),
                             trace_override or scenario.job_trace(),
                             scenario.make_scheduler(),
                             scenario.make_governor(),
                             failures=_faults.ref_failures(scenario.failures))
        return Result.from_ref(scenario, db, res)

    # no-op fault specs (empty / all-inf) normalise to plan=None: the
    # fault-free program, as in the reference
    plan = _faults.fault_plan(scenario.failures, scenario.design.num_pes)
    if plan is not None and scenario.scheduler == "table":
        raise BackendCapabilityError(
            "fail-stop injection with the 'table' scheduler", "torch",
            "backend='ref'",
            detail="the offline ILP table pins tasks to PEs, so dead-PE "
                   "fallback needs the runtime schedulers (met/etf)")
    dev = resolve_device(device)
    tables = tables_for(scenario, device=dev)
    trace = trace_override or scenario.job_trace()
    pol = scenario.make_policy()
    if pol.dynamic:
        out = _torchk.simulate_torch_dtpm(tables, scenario.scheduler,
                                          trace.arrival_us, trace.app_index,
                                          pol, faults=plan)
        peak = out["peak_temp_c"]
    else:
        out = _torchk.simulate_torch(tables, scenario.scheduler,
                                     trace.arrival_us, trace.app_index,
                                     faults=plan)
        peak = _peak_temp_single(out, _cached_nodes(scenario.design, dev),
                                 tables.power_active, tables.power_idle,
                                 bins=scenario.thermal.bins,
                                 repeats=scenario.thermal.repeats)
    return Result.from_torch(scenario, out, scenario.design.num_pes,
                             float(peak))
