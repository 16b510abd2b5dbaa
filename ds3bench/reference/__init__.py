"""The plain reference of the benchmark: DS3's event-heap simulator in
plain Python and NumPy, which imports nothing of the program under test.

:func:`simulate_lane` runs one lane (one design, one scheduler, one
governor, one job trace) from the design point and the application names
alone, rebuilding every latency, transfer and power figure itself, under
fail-stop faults where the lane has them.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .sim import Governor, LaneResult, simulate, solve_table
from .soc import Design, get_app, tasks_per_job

__all__ = ["Design", "Governor", "LaneResult", "simulate_lane",
           "tasks_per_job"]


@functools.lru_cache(maxsize=None)
def _table(design: Design, apps: Tuple[str, ...]):
    soc, table = design.soc(), {}
    for name in apps:
        table.update(solve_table(soc, get_app(name)))
    return table


def simulate_lane(design: Design, apps: Sequence[str],
                  arrival_us: np.ndarray, app_index: np.ndarray,
                  scheduler: str, governor: str,
                  governor_params: Optional[Dict[str, float]] = None,
                  bins: int = 32, repeats: int = 3,
                  precision: str = "float32",
                  faults: Sequence[Tuple[int, float]] = ()) -> LaneResult:
    """One lane of a sweep or an evaluation.  ``governor`` is
    "performance", "design" (the design's frequency caps) or "ondemand"
    (``governor_params``: ``up_threshold``, ``sample_window_us`` and
    optionally ``thermal_dt_s``; the ladder capped at the design's caps).
    ``faults``: fail-stop ``(pe, fail_time_us)`` pairs, PEs numbered in the
    design's order (big, LITTLE, scrambler, FFT, Viterbi)."""
    params = dict(governor_params or {})
    gov = Governor(kind=governor, caps=design.freq_caps(),
                   up_threshold=params.get("up_threshold", 0.8),
                   window_us=params.get("sample_window_us", 50.0),
                   thermal_dt_s=params.get("thermal_dt_s"))
    apps = tuple(apps)
    table = _table(design, apps) if scheduler == "table" else None
    return simulate(design.soc(), [get_app(a) for a in apps],
                    np.asarray(arrival_us, np.float32),
                    np.asarray(app_index, np.int64), scheduler, gov,
                    table=table, bins=bins, repeats=repeats,
                    precision=precision, faults=faults)
