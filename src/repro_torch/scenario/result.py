"""One result surface over the reference kernel and the epoch scan.

:class:`Result` is one simulation's metrics — latency, throughput, energy,
peak temperature, utilization — whichever backend produced it; the
backend-native output (``SimResult`` or the scan's output dict of tensors)
stays reachable via ``raw``.  :class:`SweepResult` is the batched surface
of ``sweep``: one array per metric, shaped like the swept axes.

Peak temperature is backend-specific by necessity: for static governors the
``"torch"`` backend runs the binned RC co-simulation (DESIGN.md §6) while the
reference backend reports the analytical steady state of the schedule's
realised per-node power split — both upper-bound views of the same lumped
network.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import thermal as _thermal
from ..core.power import EnergyReport
from ..core.resources import ResourceDB
from ..core.simkernel_ref import SimResult
from .config import Scenario


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class Result:
    """Metrics of one simulated scenario (one metrics surface, any backend)."""
    scenario: Scenario
    backend: str                       # "ref" | "torch"
    avg_latency_us: float
    throughput_jobs_per_ms: float
    makespan_us: float
    energy_j: float
    avg_power_w: float
    peak_temp_c: float
    utilization: np.ndarray            # (num_pes,) busy / makespan
    raw: Any                           # SimResult (ref) | output dict (torch)
    telemetry: Optional[Any] = None    # per-window timelines (not ported yet)
    manifest: Optional[Dict] = None    # run manifest (not ported yet)

    @property
    def energy_report(self) -> Optional[EnergyReport]:
        return self.raw.energy if isinstance(self.raw, SimResult) else None

    @classmethod
    def from_ref(cls, scenario: Scenario, db: ResourceDB,
                 res: SimResult, telemetry=None) -> "Result":
        split = _thermal.node_power_split(db, res.energy.energy_per_pe_j,
                                          res.makespan_us)
        peak = float(_thermal.steady_state(split)[:3].max())
        return cls(scenario=scenario, backend="ref",
                   avg_latency_us=float(res.avg_job_latency_us),
                   throughput_jobs_per_ms=float(res.throughput_jobs_per_ms),
                   makespan_us=float(res.makespan_us),
                   energy_j=float(res.energy.total_energy_j),
                   avg_power_w=float(res.energy.avg_power_w),
                   peak_temp_c=peak,
                   utilization=res.pe_utilization(db), raw=res,
                   telemetry=telemetry)

    @classmethod
    def from_torch(cls, scenario: Scenario, out: Dict, num_pes: int,
                   peak_temp_c: float, telemetry=None) -> "Result":
        makespan = float(_np(out["makespan_us"]))
        num_jobs = int(out["job_finish"].shape[0])
        energy = float(_np(out["energy_j"]))
        busy = _np(out["busy_per_pe_us"]).astype(np.float64)[:num_pes]
        return cls(scenario=scenario, backend="torch",
                   avg_latency_us=float(_np(out["avg_job_latency_us"])),
                   throughput_jobs_per_ms=num_jobs / max(makespan, 1e-9) * 1e3,
                   makespan_us=makespan, energy_j=energy,
                   avg_power_w=energy / max(makespan * 1e-6, 1e-12),
                   peak_temp_c=float(peak_temp_c),
                   utilization=busy / max(makespan, 1e-9), raw=out,
                   telemetry=telemetry)


@dataclasses.dataclass
class SweepResult:
    """Metrics of a ``sweep()``: one ndarray per metric, shaped like the
    cross-product of the sweep axes (in the axes-dict order)."""
    base: Scenario
    backend: str                       # "ref" | "torch"
    axes: Dict[str, Tuple]             # axis name -> swept values
    avg_latency_us: np.ndarray
    throughput_jobs_per_ms: np.ndarray
    makespan_us: np.ndarray
    energy_j: np.ndarray
    peak_temp_c: np.ndarray
    busy_per_pe_us: np.ndarray         # shape + (padded num_pes,)
    telemetry: Optional[np.ndarray] = None   # per-lane timelines (not ported yet)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v) for v in self.axes.values())

    @property
    def num_points(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def utilization(self) -> np.ndarray:
        return self.busy_per_pe_us / np.maximum(
            self.makespan_us[..., None], 1e-9)

    def iter_records(self) -> Iterator[Tuple[Dict[str, Any], Dict[str, float]]]:
        """Yield (axis-coordinates, metrics) per sweep point, C order."""
        names = list(self.axes)
        for idx in np.ndindex(*self.shape):
            coords = {n: self.axes[n][i] for n, i in zip(names, idx)}
            yield coords, dict(
                avg_latency_us=float(self.avg_latency_us[idx]),
                throughput_jobs_per_ms=float(
                    self.throughput_jobs_per_ms[idx]),
                makespan_us=float(self.makespan_us[idx]),
                energy_j=float(self.energy_j[idx]),
                peak_temp_c=float(self.peak_temp_c[idx]))
