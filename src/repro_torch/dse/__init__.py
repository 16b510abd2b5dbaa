"""repro_torch.dse — batched design-space exploration on PyTorch.

The twin of ``repro.dse``: the paper's "design space exploration" mode.

    space:         DesignSpace / DesignPoint — declarative SoC configurations
                   with grid / random / latin-hypercube enumeration
    batch:         pad + stack per-design SimTables into (D, …) tensors;
                   designs × traces simulated in one epoch scan
    thermal_torch: the binned RC co-simulation -> peak temperature, one
                   schedule or a whole grid of them; the forward-Euler
                   transient
    pareto:        non-dominated sorting + crowding distance
    search:        evaluate / successive_halving / pareto_search refinement
    reports:       ASCII/CSV front reports + ``python -m
                   repro_torch.dse.reports``

Design sweeps are one axis of ``repro_torch.scenario.sweep``:
``sweep(scenario, axes={"design": points, …})`` supersedes calling
``build_design_batch`` + ``simulate_design_batch`` by hand (the latter is
kept as a deprecation shim, as in the reference).
"""
from ..core._deprecation import deprecated_entry_point as _deprecated_entry_point
from .batch import (DesignBatch, build_design_batch, stack_tables,
                    stack_traces)
from .batch import simulate_design_batch as _simulate_design_batch_impl
from .pareto import (crowding_distance, non_dominated_sort, pareto_mask,
                     pareto_order)
from .reports import format_front, front_csv
from .search import (OBJECTIVES, EvalResult, SearchResult, evaluate,
                     pareto_search, successive_halving)
from .space import AREA_MM2, AXES, DesignPoint, DesignSpace
from .thermal_torch import (binned_power_trace, euler_step, peak_temperature,
                            peak_temperature_grid, rc_state_matrix,
                            steady_state, transient_trace)


simulate_design_batch = _deprecated_entry_point(
    _simulate_design_batch_impl,
    "repro_torch.scenario.sweep(Scenario(...), axes={'design': ..., ...})")


__all__ = [n for n in dir() if not n.startswith("_")]
