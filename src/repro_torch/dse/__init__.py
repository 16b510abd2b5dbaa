"""repro_torch.dse — batched design-space exploration, as far as ported.

    space:         DesignSpace / DesignPoint — declarative SoC configurations
    batch:         pad + stack per-design SimTables into (D, …) tensors;
                   designs × traces simulated in one epoch scan
    thermal_torch: the binned RC co-simulation -> peak temperature, one
                   schedule or a whole grid of them

Design sweeps are one axis of ``repro_torch.scenario.sweep``.  Pareto
search and reports are a later slice (ROADMAP.md queue 1, item 7).
"""
from .batch import (DesignBatch, build_design_batch, pad_node_map,
                    simulate_design_batch, stack_tables, stack_traces)
from .space import AREA_MM2, AXES, DesignPoint, DesignSpace
from .thermal_torch import (binned_power_trace, peak_temperature,
                            peak_temperature_grid, steady_state)

__all__ = ["AREA_MM2", "AXES", "DesignBatch", "DesignPoint", "DesignSpace",
           "binned_power_trace", "build_design_batch", "pad_node_map",
           "peak_temperature", "peak_temperature_grid",
           "simulate_design_batch", "stack_tables", "stack_traces",
           "steady_state"]
