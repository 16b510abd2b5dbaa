"""repro_torch.scenario — the declarative entry point, as far as ported.

One frozen :class:`Scenario` names the SoC design, application mix, workload
trace, scheduler policy, DVFS governor, thermal settings and failure
injection; ``run(scenario, backend="torch"|"ref", device=...)`` simulates it
and returns one :class:`Result`.  ``sweep`` is a later slice (ROADMAP.md
queue 1, item 6).  ``run`` defaults to the card (``backend="torch"``,
``device="cuda"``), unlike the reference's ``run``.
"""
from .config import Scenario, ThermalSpec, TraceSpec
from .errors import BackendCapabilityError, LaneAxisError, ScenarioError
from .faults import FaultSpec, pe_loss_faults
from .result import Result
from .run import run, tables_for

__all__ = ["Scenario", "ThermalSpec", "TraceSpec", "FaultSpec",
           "pe_loss_faults", "Result", "run", "tables_for", "ScenarioError",
           "BackendCapabilityError", "LaneAxisError"]
