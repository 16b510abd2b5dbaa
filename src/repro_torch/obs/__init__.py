"""repro_torch.obs — run instrumentation, the twin of ``repro.obs``.

Three surfaces, one package:

* :mod:`repro_torch.obs.metrics` — named counters/timers plus the run
  manifest attached to every ``Result`` and every ``BENCH_*.json`` (it
  names the device a run used), and the program spans, live only under
  ``torch.profiler``;
* :mod:`repro_torch.obs.telemetry` — per-sampling-window ``(W, C)``
  timelines of cluster frequency, utilisation, power and RC node
  temperature: recorded in the event-heap kernel's loop, replayed over K1's
  outputs for the ``"torch"`` backend without touching the scan;
* :mod:`repro_torch.obs.trace` — Chrome trace-event JSON (Perfetto-loadable)
  of an event-heap run's schedule: one track per PE, counter tracks for
  frequency and temperature.

``python -m repro_torch.obs.report`` renders timeline summaries from run and
bench JSON files (either package's) and writes the Perfetto trace;
:mod:`repro_torch.obs.bench` holds the benchmarks' shared CLI.

Only :mod:`.metrics` (stdlib-only at import) is imported eagerly — the
scenario and dse modules import it for their counters, so this package must
not import them back at module scope (lazy re-exports below break the cycle).
"""
from . import metrics
from .metrics import (Counter, Timer, counter, reset_all, run_manifest,
                      scenario_hash, snapshot, span, timer)

_LAZY = {
    "Telemetry": "telemetry",
    "TelemetryRecorder": "telemetry",
    "chrome_trace": "trace",
    "write_chrome_trace": "trace",
    "validate_chrome_trace": "trace",
    "bench_cli": "bench",
    "scaled": "bench",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = ["metrics", "Counter", "Timer", "counter", "timer", "span",
           "snapshot", "reset_all", "run_manifest", "scenario_hash", *_LAZY]
