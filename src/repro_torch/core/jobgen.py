"""Job generator — injects application instances following a distribution.

The paper: "The simulation is driven by the job generator which injects
instances of an application to the simulator following a given probability
distribution."  We support Poisson (exponential inter-arrival, parameterised
by an injection *rate* in jobs/ms as in Fig. 3) and deterministic arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobTrace:
    """A realised workload: arrival time (us) + application index per job."""
    arrival_us: np.ndarray        # (num_jobs,) float32, sorted
    app_index: np.ndarray         # (num_jobs,) int32 into the app list
    app_names: Sequence[str]

    @property
    def num_jobs(self) -> int:
        return int(self.arrival_us.shape[0])


def poisson_trace(rate_jobs_per_ms: float, num_jobs: int, app_names: Sequence[str],
                  seed: int = 0, mix: Optional[Sequence[float]] = None) -> JobTrace:
    """Poisson arrivals at ``rate_jobs_per_ms``; app chosen from ``mix``."""
    rng = np.random.default_rng(seed)
    mean_gap_us = 1000.0 / float(rate_jobs_per_ms)
    gaps = rng.exponential(mean_gap_us, size=num_jobs).astype(np.float32)
    arrivals = np.cumsum(gaps, dtype=np.float32)
    probs = np.asarray(mix, dtype=np.float64) if mix is not None else None
    if probs is not None:
        probs = probs / probs.sum()
    idx = rng.choice(len(app_names), size=num_jobs, p=probs).astype(np.int32)
    return JobTrace(arrivals, idx, tuple(app_names))


def deterministic_trace(gap_us: float, num_jobs: int, app_names: Sequence[str],
                        seed: int = 0) -> JobTrace:
    arrivals = (np.arange(1, num_jobs + 1, dtype=np.float32)) * np.float32(gap_us)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(app_names), size=num_jobs).astype(np.int32)
    return JobTrace(arrivals, idx, tuple(app_names))


def rate_sweep(rates: Sequence[float], num_jobs: int, app_names: Sequence[str],
               seed: int = 0) -> List[JobTrace]:
    """One trace per injection rate (paper Fig. 3 x-axis)."""
    return [poisson_trace(r, num_jobs, app_names, seed=seed + i)
            for i, r in enumerate(rates)]
