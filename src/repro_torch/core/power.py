"""Analytical power & energy models (paper §2, after Bhat et al. TVLSI'18).

Dynamic power of a CPU PE at operating point (f GHz, V volt):
    P_dyn = Ceff · V² · f          [W]   (Ceff in nF ⇒ numbers land in watts)
Static leakage is a per-type constant.  Accelerators have a fixed active
power.  Energy = Σ P·Δt over busy/idle intervals.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .resources import (ACC_POWER_ACTIVE, NOMINAL_FREQ, OPP_TABLE, PE,
                        POWER_COEFF, ResourceDB)


def opp_voltage(pe_type: str, freq_ghz: float) -> float:
    """Voltage at the smallest OPP with f >= freq (linear clamp at ends)."""
    table = OPP_TABLE[pe_type]
    freqs = [f for f, _ in table]
    i = bisect.bisect_left(freqs, freq_ghz - 1e-9)
    i = min(i, len(table) - 1)
    return table[i][1]


def active_power(pe: PE, freq_ghz: float) -> float:
    """Active power draw (W) of a PE executing a task."""
    if pe.is_cpu:
        v = opp_voltage(pe.pe_type, freq_ghz)
        c = POWER_COEFF[pe.pe_type]
        return c["ceff"] * v * v * freq_ghz + c["leak"]
    return ACC_POWER_ACTIVE[pe.pe_type] + POWER_COEFF[pe.pe_type]["leak"]


def idle_power(pe: PE) -> float:
    return POWER_COEFF[pe.pe_type]["leak"]


@dataclasses.dataclass
class EnergyReport:
    total_energy_j: float
    energy_per_pe_j: np.ndarray           # (num_pes,)
    busy_per_pe_us: np.ndarray            # (num_pes,)
    avg_power_w: float
    makespan_us: float


def energy_from_schedule(db: ResourceDB,
                         intervals: Sequence[Tuple[int, float, float, float]],
                         makespan_us: float) -> EnergyReport:
    """Integrate energy over a realised schedule.

    ``intervals``: (pe_id, start_us, finish_us, freq_ghz) per executed task.
    Idle time at leakage power fills the rest of the makespan.
    """
    n = db.num_pes
    busy = np.zeros(n, dtype=np.float64)
    e = np.zeros(n, dtype=np.float64)
    for pe_id, s, f, freq in intervals:
        pe = db.pes[pe_id]
        dt = max(0.0, f - s)
        busy[pe_id] += dt
        e[pe_id] += active_power(pe, freq) * dt          # W·us = uJ
    for j, pe in enumerate(db.pes):
        idle = max(0.0, makespan_us - busy[j])
        e[j] += idle_power(pe) * idle
    total_j = float(e.sum()) * 1e-6                      # uJ -> J
    avg_p = float(e.sum()) * 1e-6 / max(makespan_us * 1e-6, 1e-12)
    return EnergyReport(total_j, e * 1e-6, busy, avg_p, makespan_us)
