"""DS3 core, as far as the port has come: the job generator only.

The simulator itself (resources, applications, schedulers, the epoch-scan
kernel) is a later slice; see ROADMAP.md queue 1.
"""
from .jobgen import JobTrace, deterministic_trace, poisson_trace, rate_sweep

__all__ = ["JobTrace", "deterministic_trace", "poisson_trace", "rate_sweep"]
