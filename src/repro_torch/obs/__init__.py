"""repro_torch.obs — run instrumentation, as far as ported.

:mod:`repro_torch.obs.metrics` holds the named counters and timers (the
twin of the JAX-free part of ``repro.obs.metrics``).  The run manifest,
per-window telemetry, the Chrome trace and ``python -m repro.obs.report``
are a later slice (ROADMAP.md queue 1, item 9).
"""
from . import metrics
from .metrics import (Counter, Timer, counter, reset_all, scenario_hash,
                      snapshot, timer)

__all__ = ["metrics", "Counter", "Timer", "counter", "timer", "snapshot",
           "reset_all", "scenario_hash"]
