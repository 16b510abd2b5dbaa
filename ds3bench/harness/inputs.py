"""Job traces from a seed: the benchmark's own Poisson generator.

A traffic file's ``traces`` block gives the rates (a list, or
``{"linspace": [lo, hi, n]}``), the traces drawn at each rate and the jobs a
trace.  Every seed gets the same rates and sizes; the seed only draws the
arrival gaps and the application of each job.  A pool holds several such
sets, drawn independently, so that consecutive calls never repeat inputs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trace:
    arrival_us: np.ndarray      # (J,) float32, ascending
    app_index: np.ndarray       # (J,) int32 into the configuration's apps
    rate_jobs_per_ms: float


def rates(spec) -> List[float]:
    if isinstance(spec, dict):
        lo, hi, n = spec["linspace"]
        return [float(r) for r in np.linspace(lo, hi, int(n))]
    return [float(r) for r in spec]


def poisson(rng: np.random.Generator, rate_jobs_per_ms: float, jobs: int,
            num_apps: int) -> Trace:
    """Exponential gaps at ``rate`` jobs/ms (float32 arrivals in us), each
    job's application drawn uniformly."""
    gaps = rng.exponential(1000.0 / rate_jobs_per_ms, size=jobs)
    arrival = np.cumsum(gaps.astype(np.float32), dtype=np.float32)
    apps = rng.choice(num_apps, size=jobs).astype(np.int32)
    return Trace(arrival, apps, rate_jobs_per_ms)


def trace_set(spec: dict, num_apps: int, seed: int, k: int) -> List[Trace]:
    """Set ``k`` of a seed: the rates in order, ``per_rate`` traces each
    (rate-major)."""
    rng = np.random.default_rng([seed % 2 ** 64, k])
    out = []
    for r in rates(spec["rates_jobs_per_ms"]):
        for _ in range(int(spec["per_rate"])):
            out.append(poisson(rng, r, int(spec["jobs"]), num_apps))
    return out


def pool(spec: dict, num_apps: int, seed: int, size: int) -> List[List[Trace]]:
    return [trace_set(spec, num_apps, seed, k) for k in range(size)]


def tasks(traces: Sequence[Trace], tasks_per_app: np.ndarray) -> np.ndarray:
    """(S,) tasks in each trace."""
    return np.asarray([int(tasks_per_app[t.app_index].sum()) for t in traces],
                      np.int64)
