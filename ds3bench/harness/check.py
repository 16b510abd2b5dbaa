"""Whether the answers the timed calls returned are right: a sample of lanes,
drawn from the seed, against the plain reference (``ds3bench/reference``).

Each lane is simulated again by the reference from its design point,
scheduler, governor, fail-stop faults and job trace alone, and each answer
the call returned for it is compared.  The numbers compared are the widest gaps over the
sample:

* ``latency``: |program - reference| / reference, average job latency;
* ``makespan``: the same, of the makespan (``sweep`` only);
* ``energy``: the same, of the energy;
* ``busy``: the largest |program - reference| of a PE's busy time over the
  reference's makespan (``sweep`` only; padded PE slots read 0);
* ``temp``: |program - reference| of the peak temperature over the
  reference's rise above ambient.

A cell's limits file gives each number's limit.  The control puts the
reference computed in bfloat16 times in the program's place (``control``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..reference import Design, simulate_lane
from ..reference.thermal import T_AMBIENT_C
from .entries import Lane

NUMBERS = ("latency", "makespan", "energy", "busy", "temp")


def sample(seed: int, calls: int, lanes: int, k: int) -> List[Tuple[int, int]]:
    """``k`` distinct (call, lane) pairs drawn from the seed."""
    rng = np.random.default_rng([seed % 2 ** 64, 0xC4EC])
    total = calls * lanes
    picks = rng.choice(total, size=min(k, total), replace=False)
    return [(int(p) // lanes, int(p) % lanes) for p in sorted(picks)]


def reference(config: dict, lane: Lane, trace, precision: str = "float32"):
    th = config.get("thermal", {})
    return simulate_lane(Design(*lane.design), config["apps"],
                         trace.arrival_us, trace.app_index, lane.scheduler,
                         lane.governor, lane.params,
                         bins=th.get("bins", 32), repeats=th.get("repeats", 3),
                         precision=precision, faults=lane.faults)


def answers_of(res) -> Dict[str, np.ndarray]:
    """A reference lane's answers, keyed as the program's."""
    return dict(avg_latency_us=res.avg_latency_us, makespan_us=res.makespan_us,
                energy_j=res.energy_j, peak_temp_c=res.peak_temp_c,
                busy_per_pe_us=res.busy_per_pe_us)


def _rel(a: float, b: float) -> float:
    a, b = float(a), float(b)
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def gaps(got: Dict[str, np.ndarray], want) -> Dict[str, float]:
    """The gaps of one lane's answers ``got`` from the reference's ``want``
    (a ``LaneResult``); only the answers the entry returns."""
    out = {"latency": _rel(got["avg_latency_us"], want.avg_latency_us),
           "energy": _rel(got["energy_j"], want.energy_j),
           "temp": abs(float(got["peak_temp_c"]) - want.peak_temp_c)
           / max(want.peak_temp_c - T_AMBIENT_C, 1e-30)}
    if not math.isfinite(out["temp"]):
        out["temp"] = math.inf
    if "makespan_us" in got:
        out["makespan"] = _rel(got["makespan_us"], want.makespan_us)
    if "busy_per_pe_us" in got:
        busy = np.asarray(got["busy_per_pe_us"], np.float64)
        ref = np.zeros_like(busy)
        ref[:len(want.busy_per_pe_us)] = want.busy_per_pe_us
        d = np.abs(busy - ref).max() / max(want.makespan_us, 1e-30)
        out["busy"] = float(d) if np.isfinite(d) else math.inf
    return out


def widest(per_lane: Sequence[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for g in per_lane:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v)
    return {k: out[k] for k in NUMBERS if k in out}


def judge(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and every limit's number read."""
    return set(found) == set(limits) and all(
        math.isfinite(found[k]) and found[k] <= limits[k] for k in limits)
