"""Batched design-space evaluation + Pareto refinement loop, on PyTorch.

The twin of ``src/repro/dse/search.py``.  ``evaluate`` turns a list of
design points into (latency, energy, peak-temp) objectives with ONE epoch
scan per scheduler policy (one K1 launch on a CUDA device; ``chunk=N``
streams the designs in N-design launches).  It is a thin delegate over the
``repro_torch.scenario`` facade: the design list becomes a
``sweep(scenario, axes={"design": …, "trace": …})`` whose schedule-plus-
thermal grid lives in ``repro_torch.scenario.sweep``.

``pareto_search`` is the refinement loop (DS3-journal style DSE): seed a
latin-hypercube batch, keep a cross-round archive, and re-seed each next
batch from the current non-dominated front's neighborhood (one-axis moves)
plus random immigrants.  ``successive_halving`` optionally triages each
batch on a trace subset before paying for the full evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.applications import Application
from ..core.jobgen import JobTrace
from ..obs import metrics as _metrics
from .batch import DesignBatch, build_design_batch
from .pareto import pareto_mask, pareto_order
from .space import DesignPoint, DesignSpace

OBJECTIVES = ("avg_latency_us", "energy_j", "peak_temp_c")
DEGRADED_OBJECTIVE = "degraded_latency_us"


def _lane_fires(fault_set) -> bool:
    """True when a fault-lane value contains at least one firing event."""
    from ..scenario.faults import normalize_failures
    return any(not f.is_noop for f in normalize_failures(fault_set))


@dataclasses.dataclass
class EvalResult:
    """Objectives for D designs, averaged/maxed over S traces.

    When ``evaluate(faults=...)`` swept fail-stop lanes, the three
    ``degraded_*`` fields carry the resilience metric (DESIGN.md §14):
    per-design worst case over the fault lanes of the trace-mean
    latency/energy — how gracefully the design degrades when it loses PEs.
    """
    points: Tuple[DesignPoint, ...]
    avg_latency_us: np.ndarray        # (D,) mean over traces
    energy_j: np.ndarray              # (D,) mean over traces
    peak_temp_c: np.ndarray           # (D,) max over traces
    latency_per_trace_us: np.ndarray     # (D, S)
    energy_per_trace_j: np.ndarray      # (D, S)
    temp_per_trace_c: np.ndarray        # (D, S)
    degraded_latency_us: Optional[np.ndarray] = None   # (D,) worst fault lane
    degraded_energy_j: Optional[np.ndarray] = None     # (D,) worst fault lane
    latency_per_fault_us: Optional[np.ndarray] = None  # (F, D) trace means

    @property
    def num_designs(self) -> int:
        return len(self.points)

    def objectives(self) -> np.ndarray:
        """(D, 3) cost matrix (all minimised) in OBJECTIVES order — (D, 4)
        with the degraded-latency resilience column when faults were swept."""
        cols = [self.avg_latency_us, self.energy_j, self.peak_temp_c]
        if self.degraded_latency_us is not None:
            cols.append(self.degraded_latency_us)
        return np.stack(cols, axis=1)

    def front_mask(self) -> np.ndarray:
        return pareto_mask(self.objectives())


def _cat_opt(x, y, axis: int = 0):
    return (np.concatenate([x, y], axis=axis)
            if x is not None and y is not None else None)


def _concat(a: "EvalResult", b: "EvalResult") -> "EvalResult":
    return EvalResult(
        points=a.points + b.points,
        avg_latency_us=np.concatenate([a.avg_latency_us, b.avg_latency_us]),
        energy_j=np.concatenate([a.energy_j, b.energy_j]),
        peak_temp_c=np.concatenate([a.peak_temp_c, b.peak_temp_c]),
        latency_per_trace_us=np.concatenate([a.latency_per_trace_us,
                                          b.latency_per_trace_us]),
        energy_per_trace_j=np.concatenate([a.energy_per_trace_j,
                                         b.energy_per_trace_j]),
        temp_per_trace_c=np.concatenate([a.temp_per_trace_c, b.temp_per_trace_c]),
        degraded_latency_us=_cat_opt(a.degraded_latency_us,
                                     b.degraded_latency_us),
        degraded_energy_j=_cat_opt(a.degraded_energy_j, b.degraded_energy_j),
        latency_per_fault_us=_cat_opt(a.latency_per_fault_us,
                                      b.latency_per_fault_us, axis=1))


@_metrics.spanned(_metrics.ENTRY)
def evaluate(points: Sequence[DesignPoint], apps: Sequence[Application],
             traces: Sequence[JobTrace], policy: str = "etf",
             thermal_bins: int = 32, thermal_repeats: int = 3,
             pad_pes: Optional[int] = None,
             batch: Optional[DesignBatch] = None,
             governor: str = "design",
             governor_params: Tuple[Tuple[str, float], ...] = (),
             chunk: Optional[int] = None,
             shard: Optional[bool] = None,
             faults: Optional[Sequence] = None,
             device="cuda") -> EvalResult:
    """Evaluate D designs × S traces in one epoch scan per policy, on
    ``device`` (``"cuda"`` by default, which raises where there is no card;
    ``"cpu"`` runs K1's plain version).

    ``pad_pes`` fixes the padded PE width, so successive calls with
    different design mixes run scans of one table shape.

    ``chunk``/``shard`` delegate to the sweep's sharded and chunked lane
    executor (``scenario.shardexec``, DESIGN.md §13): the design lanes
    stream in fixed-width chunks with bounded device memory, and ``shard``
    splits each chunk over the lane devices (``sharding.lane_devices``: the
    CUDA cards, or N virtual ones), both equal to the plain batched call
    bit for bit; ``pareto_search``/``successive_halving`` pass them (and
    ``device``) through ``eval_kw`` unchanged.

    ``governor`` widens the DVFS axis of the search: the default ``"design"``
    pins each design's static frequency caps; a *dynamic* governor
    (``"ondemand"`` / ``"throttle"``, parameterised via ``governor_params``)
    ranks closed-loop DTPM policies instead — the stacked tables gain the
    OPP dimension (each design's ladder truncated at its caps) and peak
    temperature comes from the kernel's inline RC loop, so
    ``thermal_bins``/``thermal_repeats`` only shape the static path.

    ``faults`` adds a resilience objective: a sequence of fail-stop fault
    sets (e.g. ``repro_torch.scenario.pe_loss_faults(range(4), k=1)`` —
    every 1-PE-loss of the first cluster) swept as one extra lane axis
    through the same epoch scan per policy.  The degraded-mode
    latency/energy (worst case over the fault lanes of the trace means)
    land on ``EvalResult.degraded_*``, and ``objectives()`` grows the
    degraded-latency column so the Pareto front trades peak performance
    against graceful degradation (DESIGN.md §14).
    """
    # lazy import: repro_torch.scenario builds on repro_torch.dse, not the
    # reverse
    from ..scenario import Scenario, ThermalSpec
    from ..scenario.sweep import sweep

    governor_params = tuple(governor_params)
    base = Scenario(apps=tuple(apps), scheduler=policy, governor=governor,
                    governor_params=governor_params,
                    thermal=ThermalSpec(bins=thermal_bins,
                                        repeats=thermal_repeats))
    dynamic = base.make_policy().dynamic
    if dynamic and "thermal_dt_s" not in dict(governor_params):
        # real-time RC integration keeps millisecond traces at ambient,
        # collapsing the temperature objective to float noise — default the
        # thermal dilation to the throttle governor's 50 ms so peak_temp_c
        # actually separates designs (override via governor_params)
        governor_params += (("thermal_dt_s", 0.05),)
        base = dataclasses.replace(base, governor_params=governor_params)
    if not dynamic and governor != "design":
        raise ValueError(
            "static DVFS points are the design axis itself — use "
            "governor='design' (per-design frequency caps) or a dynamic "
            "governor ('ondemand'/'throttle') for DTPM-policy ranking")
    if batch is None:
        batch = build_design_batch(
            points, apps, pad_pes=pad_pes,
            governor=base.make_governor() if dynamic else None,
            device=device)
    elif tuple(points) != batch.points:
        raise ValueError("points does not match batch.points — pass the same "
                         "design list the batch was built from")
    if batch.dynamic != dynamic:
        raise ValueError(
            "design batch and governor disagree: rebuild the batch with "
            "build_design_batch(..., governor=...) matching the governor")
    axes: Dict = {"design": list(batch.points), "trace": list(traces)}
    if faults is not None:
        axes["faults"] = list(faults)
    sr = sweep(base, axes=axes, backend="torch", device=device,
               design_batch=batch, chunk=chunk, shard=shard)
    lat, energy, temps = sr.avg_latency_us, sr.energy_j, sr.peak_temp_c
    deg_kw: Dict = {}
    if faults is not None:
        # (D, S, F) per the axes-dict order; worst fault lane of trace means
        lat_f = np.moveaxis(lat, 2, 0)            # (F, D, S)
        en_f = np.moveaxis(energy, 2, 0)
        deg_kw = dict(degraded_latency_us=lat_f.mean(axis=2).max(axis=0),
                      degraded_energy_j=en_f.mean(axis=2).max(axis=0),
                      latency_per_fault_us=lat_f.mean(axis=2))
        # the nominal objectives stay the fault-free ones: the first
        # all-no-op lane if present, else the first lane
        noop = next((i for i, fs in enumerate(axes["faults"])
                     if not _lane_fires(fs)), 0)
        lat, energy, temps = lat[:, :, noop], energy[:, :, noop], \
            temps[:, :, noop]
    return EvalResult(points=tuple(batch.points),
                      avg_latency_us=lat.mean(axis=1),
                      energy_j=energy.mean(axis=1),
                      peak_temp_c=temps.max(axis=1),
                      latency_per_trace_us=lat, energy_per_trace_j=energy,
                      temp_per_trace_c=temps, **deg_kw)


def successive_halving(points: Sequence[DesignPoint],
                       apps: Sequence[Application],
                       traces: Sequence[JobTrace], policy: str = "etf",
                       eta: int = 2, min_survivors: int = 4,
                       pad_pes: Optional[int] = None,
                       **eval_kw) -> EvalResult:
    """Triaged evaluation: rank all candidates on ONE trace, keep the best
    1/eta (by Pareto order) for the full-trace evaluation.  Returns the full
    result for survivors only — a cheap filter in front of ``evaluate``."""
    if len(traces) <= 1 or len(points) <= min_survivors:
        return evaluate(points, apps, traces, policy, pad_pes=pad_pes,
                        **eval_kw)
    cheap = evaluate(points, apps, traces[:1], policy, pad_pes=pad_pes,
                     **eval_kw)
    keep = max(min_survivors, len(points) // eta)
    order = pareto_order(cheap.objectives())[:keep]
    survivors = [points[i] for i in sorted(order)]
    return evaluate(survivors, apps, traces, policy, pad_pes=pad_pes,
                    **eval_kw)


@dataclasses.dataclass
class SearchResult:
    archive: EvalResult               # every design ever fully evaluated
    front: np.ndarray                 # bool mask over the archive
    rounds: List[Dict]                # per-round stats (evaluated, front size)

    def front_points(self) -> List[Tuple[DesignPoint, np.ndarray]]:
        obj = self.archive.objectives()
        idx = [i for i in np.flatnonzero(self.front)]
        order = pareto_order(obj[self.front])
        return [(self.archive.points[idx[i]], obj[idx[i]]) for i in order]


def pareto_search(space: DesignSpace, apps: Sequence[Application],
                  traces: Sequence[JobTrace], policy: str = "etf",
                  rounds: int = 4, batch_size: int = 32, seed: int = 0,
                  budget_mm2: Optional[float] = None, halving: bool = False,
                  pad_pes: Optional[int] = None, **eval_kw) -> SearchResult:
    """Evolutionary Pareto refinement over ``space``.

    Round 0 seeds a latin-hypercube batch; each later round mutates the
    current front (all one-axis neighbour moves, crowding-ordered) and tops
    up with unseen random immigrants, so the batch stays ``batch_size`` wide
    and every batched evaluation is full.  Deterministic for a given seed.
    """
    if pad_pes is None:
        # widest possible design in this space -> one table shape
        pad_pes = (max(space.num_big) + max(space.num_little)
                   + max(space.num_scr) + max(space.num_fft)
                   + max(space.num_vit))
    seen: set = set()
    archive: Optional[EvalResult] = None
    round_stats: List[Dict] = []
    candidates = space.sample_lhs(batch_size, seed=seed,
                                  budget_mm2=budget_mm2)
    if not candidates:
        raise ValueError(
            f"no feasible designs in the space under budget_mm2={budget_mm2}")
    for rnd in range(rounds):
        candidates = [p for p in candidates if p not in seen]
        if not candidates:
            break
        seen.update(candidates)
        t_round = _metrics.timer("dse.pareto_search.round")
        with t_round:
            ev = (successive_halving(candidates, apps, traces, policy,
                                     pad_pes=pad_pes, **eval_kw) if halving
                  else evaluate(candidates, apps, traces, policy,
                                pad_pes=pad_pes, **eval_kw))
        _metrics.counter("dse.search.designs_evaluated").inc(ev.num_designs)
        archive = ev if archive is None else _concat(archive, ev)
        front = archive.front_mask()
        round_stats.append(dict(round=rnd, evaluated=ev.num_designs,
                                archive=archive.num_designs,
                                front=int(front.sum()),
                                wall_s=t_round.last_s))
        if rnd == rounds - 1:
            break
        # next generation: neighbourhood of the front, best-crowding first
        front_idx = np.flatnonzero(front)
        obj = archive.objectives()
        ordered = pareto_order(obj[front])
        nxt: List[DesignPoint] = []
        for i in ordered:
            for q in space.neighbors(archive.points[front_idx[i]]):
                if q not in seen and q not in nxt:
                    if budget_mm2 is None or q.area_mm2 <= budget_mm2:
                        nxt.append(q)
        # reserve at least a quarter of the batch for random immigrants
        nxt = nxt[:max(1, batch_size - max(1, batch_size // 4))]
        immigrants = space.sample_random(
            batch_size - len(nxt), seed=seed + 1000 + rnd,
            budget_mm2=budget_mm2, exclude=list(seen) + nxt)
        candidates = nxt + immigrants
    return SearchResult(archive=archive, front=archive.front_mask(),
                        rounds=round_stats)
