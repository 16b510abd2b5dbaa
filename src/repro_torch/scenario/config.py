"""Declarative scenario configuration — one frozen dataclass wires a run.

A :class:`Scenario` names everything a simulation needs — the SoC design
point, the application mix, the workload trace, the scheduler policy, the
DVFS governor, the thermal-evaluation settings and optional fail-stop
events — without materialising any of it.  Materialisation (``soc()``,
``applications()``, ``job_trace()``, ``make_scheduler()``…) happens in
exactly one place, so every driver (benchmarks, examples, DSE, tests)
constructs work the same way.

``Scenario`` and its sub-specs are frozen, hashable dataclasses: a scenario
serves as a cache key (see ``repro_torch.scenario.run._cached_tables``).
See DESIGN.md §9.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

from ..core.applications import Application, get_application
from ..core.dvfs import Governor, GovernorPolicy, get_governor
from ..core.jobgen import JobTrace, deterministic_trace, poisson_trace
from ..core.resources import ResourceDB
from ..core.schedulers import (Scheduler, TableScheduler, get_scheduler,
                               solve_optimal_table)
from ..dse.space import DesignPoint
from .faults import FaultSpec, normalize_failures


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Declarative workload: which jobs arrive when (materialised lazily).

    ``kind="poisson"`` draws exponential inter-arrival gaps at
    ``rate_jobs_per_ms`` (paper Fig. 3 x-axis); ``kind="deterministic"``
    spaces jobs ``gap_us`` apart.  ``mix`` optionally weights the choice
    among the scenario's applications.
    """
    kind: str = "poisson"                      # "poisson" | "deterministic"
    rate_jobs_per_ms: float = 20.0
    gap_us: float = 50.0                       # deterministic arrivals only
    num_jobs: int = 100
    mix: Optional[Tuple[float, ...]] = None
    seed: int = 0

    def materialize(self, app_names: Tuple[str, ...]) -> JobTrace:
        if self.kind == "poisson":
            return poisson_trace(self.rate_jobs_per_ms, self.num_jobs,
                                 app_names, seed=self.seed, mix=self.mix)
        if self.kind == "deterministic":
            return deterministic_trace(self.gap_us, self.num_jobs, app_names,
                                       seed=self.seed)
        raise ValueError(f"unknown trace kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ThermalSpec:
    """RC thermal co-simulation settings (see DESIGN.md §6).

    Consulted by the *static*-governor epoch-scan path only (the post-hoc
    binned peak-temperature scan).  Dynamic (ondemand-family) scenarios integrate
    temperature inside the kernel's DVFS loop instead — their resolution is
    the governor's ``sample_window_us`` / ``thermal_dt_s`` (DESIGN.md §7),
    and ``bins``/``repeats`` have no effect.
    """
    bins: int = 32              # power-trace time bins per schedule
    repeats: int = 3            # periods scanned past the steady-state start


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative simulation configuration.

    Fields:
      design      — SoC design point (defaults to the paper's Table-2 SoC);
      apps        — application names (or ``Application`` objects) in the mix;
      trace       — workload spec (see :class:`TraceSpec`);
      scheduler   — ``"met" | "etf" | "table"`` (table = offline ILP solve);
      governor    — DVFS governor name (``repro_torch.core.dvfs.GOVERNORS``) or
                    ``"design"`` for a userspace governor pinned to the
                    design point's per-cluster frequency caps; dynamic
                    governors (``ondemand``/``throttle``) run the closed
                    DTPM loop on either backend (DESIGN.md §7);
      governor_params — extra governor kwargs as a hashable (key, value)
                    tuple, e.g. ``(("up_threshold", 0.9),)``;
      thermal     — peak-temperature evaluation settings;
      failures    — fail-stop events (:class:`FaultSpec`, …), supported on
                    both backends (DESIGN.md §14); bare
                    ``(pe_id, fail_time_us)`` tuples are accepted through a
                    one-release ``DeprecationWarning`` shim;
      telemetry   — record per-sampling-window timelines (frequency,
                    utilisation, power, temperature) on ``Result.telemetry``
                    (DESIGN.md §11).  Observation-only: the simulated
                    schedule and its metrics are unchanged.
    """
    design: DesignPoint = DesignPoint()
    apps: Tuple[Union[str, Application], ...] = ("wifi_tx",)
    trace: TraceSpec = TraceSpec()
    scheduler: str = "etf"
    governor: str = "performance"
    governor_params: Tuple[Tuple[str, float], ...] = ()
    thermal: ThermalSpec = ThermalSpec()
    failures: Tuple[FaultSpec, ...] = ()
    telemetry: bool = False

    def __post_init__(self):
        # canonicalise the failures field (legacy bare tuples warn + convert)
        # so every consumer — table cache keys included — sees FaultSpecs
        object.__setattr__(self, "failures",
                           normalize_failures(self.failures))

    # -- materialisation (the single construction point) -------------------
    def soc(self) -> ResourceDB:
        """A fresh ``ResourceDB`` for the design point."""
        return self.design.to_db()

    def applications(self) -> Tuple[Application, ...]:
        return tuple(a if isinstance(a, Application) else get_application(a)
                     for a in self.apps)

    def app_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.applications())

    def job_trace(self) -> JobTrace:
        return self.trace.materialize(self.app_names())

    def make_governor(self) -> Governor:
        if self.governor == "design":
            if self.governor_params:
                raise ValueError(
                    "governor='design' takes no governor_params (the design "
                    "point pins the frequency caps); name an explicit "
                    "governor to parameterise one")
            return self.design.governor()      # frequency-cap userspace
        gov = get_governor(self.governor, **dict(self.governor_params))
        if gov.policy().dynamic:
            # dynamic policies range over the design's hardware envelope:
            # the OPP ladder stops at the per-cluster frequency caps, on
            # both backends (capped_levels / build_tables(freq_caps=…))
            gov.freq_caps = self.design.freq_caps()
        return gov

    def make_policy(self) -> GovernorPolicy:
        """The governor's array-form per-window transition (DESIGN.md §7).

        ``policy.dynamic`` selects the kernel branch of the epoch scan:
        static governors bake one OPP into the tables, the ondemand family
        runs the closed DVFS + thermal loop inside the scan.
        """
        return self.make_governor().policy()

    def schedule_table(self) -> Optional[Dict[Tuple[str, int], int]]:
        """The offline ILP table for ``scheduler="table"`` (cached), else None."""
        if self.scheduler != "table":
            return None
        return _solve_table_cached(self.design, self.apps)

    def make_scheduler(self) -> Scheduler:
        if self.scheduler == "table":
            return TableScheduler(self.schedule_table())
        return get_scheduler(self.scheduler)

    # -- convenience -------------------------------------------------------
    def replace(self, **kwargs) -> "Scenario":
        """``dataclasses.replace`` that also resolves dotted axis paths,
        e.g. ``replace(**{"trace.seed": 3, "design.num_big": 2})``."""
        out = self
        for key, value in kwargs.items():
            if "." in key:
                head, _, field = key.partition(".")
                sub = dataclasses.replace(getattr(out, head), **{field: value})
                out = dataclasses.replace(out, **{head: sub})
            else:
                out = dataclasses.replace(out, **{key: value})
        return out

    def at_rate(self, rate_jobs_per_ms: float) -> "Scenario":
        return self.replace(**{"trace.rate_jobs_per_ms": rate_jobs_per_ms})

    def with_seed(self, seed: int) -> "Scenario":
        return self.replace(**{"trace.seed": seed})

    def label(self) -> str:
        return (f"{self.design.label()}|{'+'.join(self.app_names())}"
                f"|{self.scheduler}|{self.governor}")


@functools.lru_cache(maxsize=64)
def _solve_table_cached(design: DesignPoint,
                        apps: Tuple[Union[str, Application], ...]):
    db = design.to_db()
    table: Dict[Tuple[str, int], int] = {}
    for app in (a if isinstance(a, Application) else get_application(a)
                for a in apps):
        table.update(solve_optimal_table(db, app))
    return table

