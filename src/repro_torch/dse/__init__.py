"""repro_torch.dse — design-space exploration, as far as ported.

    space:         DesignSpace / DesignPoint — declarative SoC configurations
    thermal_torch: the binned RC co-simulation -> peak temperature

Batching, Pareto search and reports are a later slice (ROADMAP.md queue 1,
item 7).
"""
from .space import AREA_MM2, AXES, DesignPoint, DesignSpace
from .thermal_torch import binned_power_trace, peak_temperature, steady_state

__all__ = ["AREA_MM2", "AXES", "DesignPoint", "DesignSpace",
           "binned_power_trace", "peak_temperature", "steady_state"]
