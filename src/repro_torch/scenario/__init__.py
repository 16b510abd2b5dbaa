"""repro_torch.scenario — the unified, declarative entry point.

One frozen :class:`Scenario` names the SoC design, application mix, workload
trace, scheduler policy, DVFS governor, thermal settings and failure
injection; two verbs consume it:

    run(scenario, backend="torch"|"ref", device=...)    one simulation, one
                                                        Result surface
    sweep(scenario, axes={...}, backend=..., device=...) cross-product
                                                        batches, one epoch
                                                        scan per scheduler

Both default to the card (``backend="torch"``, ``device="cuda"``), unlike the
reference's, which default to ``"ref"`` and ``"jax"``; pass ``device="cpu"``
to run K1's plain version.
"""
from .config import Scenario, ThermalSpec, TraceSpec
from .errors import BackendCapabilityError, LaneAxisError, ScenarioError
from .faults import FaultSpec, pe_loss_faults
from .result import Result, SweepResult
from .run import run, tables_for
from .sweep import sweep

__all__ = ["Scenario", "ThermalSpec", "TraceSpec", "FaultSpec",
           "pe_loss_faults", "Result", "SweepResult", "run", "sweep",
           "tables_for", "ScenarioError", "BackendCapabilityError",
           "LaneAxisError"]
