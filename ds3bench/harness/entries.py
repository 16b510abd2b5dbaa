"""The calls a cell makes into the program, as its traffic file describes.

Two entries, the ways DS3's users call the port: ``sweep`` (a
``repro_torch.scenario.sweep`` over the traffic's axes) and ``evaluate``
(``repro_torch.dse.evaluate`` of a design set over the call's traces).  An
axis takes a literal list of values, or ``"traces"`` (the call's job
traces), ``"designs"`` (the configuration's design set the traffic names),
``"policies"`` (the configuration's governor parameters) or ``"faults"``
(the configuration's fault sets under the traffic's ``"fault_sets"`` key:
each a list of ``[pe_id, fail_time_us]`` pairs, PEs in the reference's
order big, LITTLE, scrambler, FFT, Viterbi; an empty list is no fault).

Each entry also says what a call's lanes are (design, scheduler, governor,
faults and trace of every answer, for the reference), the answers of a lane,
and the shapes of the epoch-scan launches a call makes (for the roofline).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..reference import tasks_per_job
from .k1bytes import Launch


@dataclasses.dataclass(frozen=True)
class Lane:
    design: Tuple            # a row of the configuration's design fields
    scheduler: str
    governor: str
    params: Optional[Dict[str, float]]
    trace: int               # index into the call's traces
    faults: Tuple = ()       # fail-stop (pe_id, fail_time_us) pairs


def _design_rows(config: dict, traffic: dict) -> List[Tuple]:
    return [tuple(r) for r in config["designs"][traffic["designs"]]]


def _num_pes(row: Sequence) -> int:
    return int(sum(row[:5]))


def _max_tasks(config: dict) -> int:
    return int(tasks_per_job(config["apps"]).max())


def _fault_sets(config: dict, traffic: dict) -> List[Tuple]:
    return [tuple((int(p), float(t)) for p, t in fs)
            for fs in config["fault_sets"][traffic["fault_sets"]]]


def _fires(fault_set: Sequence) -> bool:
    return any(math.isfinite(t) for _, t in fault_set)


class Sweep:
    """``sweep(scenario, axes)``: the answers are the result's arrays,
    shaped like the axes."""

    def __init__(self, config: dict, traffic: dict, device: str):
        self.config, self.device = config, device
        self.rows = _design_rows(config, traffic)
        self.governor = config["governors"][traffic["designs"]]
        self.axes = [(name, src) for name, src in traffic["axes"]]
        names = [n for n, _ in self.axes]
        self.fault_axis = next((n for n, s in self.axes if s == "faults"),
                               None)
        self.fault_sets = (_fault_sets(config, traffic)
                           if self.fault_axis else None)
        self.base_scheduler = traffic.get("scheduler", "etf")
        self.design_axis = "design" in names
        self.policy_axis = "governor_params" in names
        if not self.design_axis and len(self.rows) != 1:
            raise ValueError("a sweep without a design axis takes one design")

    def _values(self, src, traces) -> List:
        if src == "traces":
            return list(range(len(traces)))
        if src == "designs":
            return self.rows
        if src == "policies":
            return [dict(p) for p in self.config["policies"]]
        if src == "faults":
            return self.fault_sets
        return list(src)

    def shape(self, traces) -> Tuple[int, ...]:
        return tuple(len(self._values(s, traces)) for _, s in self.axes)

    def lanes(self, traces) -> List[Lane]:
        vals = [self._values(s, traces) for _, s in self.axes]
        out = []
        for combo in itertools.product(*vals):
            kv = dict(zip([n for n, _ in self.axes], combo))
            out.append(Lane(
                design=kv.get("design", self.rows[0]),
                scheduler=kv.get("scheduler", self.base_scheduler),
                governor=self.governor,
                params=kv.get("governor_params"),
                trace=kv["trace"],
                faults=kv.get(self.fault_axis, ())))
        return out

    def launches(self, traces) -> List[Launch]:
        """One epoch scan per scheduler value over every other axis; a fault
        axis none of whose sets fires runs the fault-free scan once over the
        other axes."""
        vals = {n: self._values(s, traces) for n, s in self.axes}
        n_sched = len(vals.get("scheduler", [None]))
        D = len(vals["design"]) if self.design_axis else 1
        faults = bool(self.fault_axis) and any(map(_fires, self.fault_sets))
        lanes = int(np.prod([len(v) for n, v in vals.items()
                             if n != "scheduler"
                             and (n != self.fault_axis or faults)]))
        rows = vals.get("design", self.rows)
        return [Launch(dtpm=self.governor == "ondemand", D=D, L=lanes,
                       J=len(traces[0].arrival_us),
                       A=len(self.config["apps"]),
                       T=_max_tasks(self.config),
                       P=max(_num_pes(r) for r in rows),
                       faults=faults)] * n_sched

    def build(self):
        """Program objects made once in set-up: the base scenario and the
        design, policy and fault axes."""
        from repro_torch.dse.space import DesignPoint
        from repro_torch.scenario import FaultSpec, Scenario, ThermalSpec
        th = self.config.get("thermal", {})
        self.scenario = Scenario(
            design=DesignPoint(*self.rows[0]), apps=tuple(self.config["apps"]),
            scheduler=self.base_scheduler, governor=self.governor,
            thermal=ThermalSpec(**th) if th else ThermalSpec())
        self.points = [DesignPoint(*r) for r in self.rows]
        self.policies = [tuple(sorted(p.items()))
                         for p in self.config["policies"]] \
            if self.policy_axis else None
        self.faults = [tuple(FaultSpec(pe_id=p, fail_time_us=t)
                             for p, t in fs)
                       for fs in self.fault_sets] if self.fault_axis else None

    def call(self, job_traces, span=None) -> Dict[str, np.ndarray]:
        from repro_torch.scenario import sweep
        axes = {}
        for name, src in self.axes:
            if src == "traces":
                axes[name] = job_traces
            elif src == "designs":
                axes[name] = self.points
            elif src == "policies":
                axes[name] = self.policies
            elif src == "faults":
                axes[name] = self.faults
            else:
                axes[name] = list(src)
        sr = sweep(self.scenario, axes, device=self.device)
        return dict(avg_latency_us=sr.avg_latency_us,
                    makespan_us=sr.makespan_us, energy_j=sr.energy_j,
                    peak_temp_c=sr.peak_temp_c,
                    busy_per_pe_us=sr.busy_per_pe_us)


class Evaluate:
    """``evaluate(designs, apps, traces, policy)``: the answers are the
    per-trace latency, energy and peak temperature of every design."""

    def __init__(self, config: dict, traffic: dict, device: str):
        self.config, self.device = config, device
        self.rows = _design_rows(config, traffic)
        self.policy = traffic["policy"]
        self.governor = config["governors"][traffic["designs"]]
        if self.governor != "design":
            raise ValueError("evaluate runs each design's own caps here")

    def shape(self, traces) -> Tuple[int, ...]:
        return (len(self.rows), len(traces))

    def lanes(self, traces) -> List[Lane]:
        return [Lane(r, self.policy, "design", None, s)
                for r in self.rows for s in range(len(traces))]

    def launches(self, traces) -> List[Launch]:
        return [Launch(dtpm=False, D=len(self.rows),
                       L=len(self.rows) * len(traces),
                       J=len(traces[0].arrival_us),
                       A=len(self.config["apps"]),
                       T=_max_tasks(self.config),
                       P=max(_num_pes(r) for r in self.rows))]

    def build(self):
        from repro_torch.core.applications import get_application
        from repro_torch.dse.space import DesignPoint
        self.points = [DesignPoint(*r) for r in self.rows]
        self.apps = [get_application(a) for a in self.config["apps"]]

    def call(self, job_traces, span=None) -> Dict[str, np.ndarray]:
        """``span`` (traced runs) wraps the benchmark's own call of the
        public ``build_design_batch``, whose batch ``evaluate`` then takes:
        the work the untraced call does inside ``evaluate``."""
        from repro_torch.dse import build_design_batch, evaluate
        th = self.config.get("thermal", {})
        kw = dict(policy=self.policy, thermal_bins=th.get("bins", 32),
                  thermal_repeats=th.get("repeats", 3), device=self.device)
        if span is not None:
            with span("ds3bench.tables"):
                kw["batch"] = build_design_batch(self.points, self.apps,
                                                 device=self.device)
        ev = evaluate(self.points, self.apps, job_traces, **kw)
        return dict(avg_latency_us=ev.latency_per_trace_us,
                    energy_j=ev.energy_per_trace_j,
                    peak_temp_c=ev.temp_per_trace_c)


ENTRIES = {"sweep": Sweep, "evaluate": Evaluate}


def make(config: dict, traffic: dict, device: str):
    return ENTRIES[traffic["entry"]](config, traffic, device)


def job_traces(traces: Sequence, app_names: Sequence[str]):
    """The program's ``JobTrace`` objects for a trace set."""
    from repro_torch.core.jobgen import JobTrace
    return [JobTrace(t.arrival_us, t.app_index, tuple(app_names))
            for t in traces]


def lane_answers(out: Dict[str, np.ndarray], shape: Tuple[int, ...],
                 index: int) -> Dict[str, np.ndarray]:
    """The answers of lane ``index`` (C order over the grid's shape)."""
    at = np.unravel_index(index, shape)
    return {k: np.asarray(v[at], np.float64) for k, v in out.items()}

