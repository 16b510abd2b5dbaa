"""Declarative SoC design space — the "what to explore" half of DSE.

A :class:`DesignPoint` is one concrete SoC: big/LITTLE core counts,
accelerator counts per type, per-cluster frequency caps and an interconnect
cross-cluster penalty.  A :class:`DesignSpace` is the cartesian hull those
points are drawn from, with three enumeration modes:

* ``grid()``            — exhaustive, deterministic product order;
* ``sample_random(n)``  — uniform without replacement (seeded);
* ``sample_lhs(n)``     — latin-hypercube over the discrete axes (seeded),
                          the default for search seeding: n points that
                          stratify every axis instead of clumping.

Budget-constrained sweeps (Lumos-style): each point carries an ``area_mm2``
proxy so ``grid(budget_mm2=...)`` walks only the affordable region.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dvfs import UserspaceGovernor
from ..core.resources import (CPU_BIG, CPU_LITTLE, OPP_TABLE, CommModel,
                              ResourceDB, make_soc)

# Die-area proxy (mm²) per PE instance — 28nm-class planning numbers, used
# only to rank/bound designs, never in the timing model itself.
AREA_MM2 = {
    "big": 4.5,        # Cortex-A15 class core + L1
    "little": 0.45,    # Cortex-A7 class core + L1
    "scr": 0.30,       # scrambler-encoder accelerator
    "fft": 1.20,       # FFT accelerator
    "vit": 1.00,       # Viterbi accelerator
}

BIG_FREQS = tuple(f for f, _ in OPP_TABLE[CPU_BIG])
LITTLE_FREQS = tuple(f for f, _ in OPP_TABLE[CPU_LITTLE])


@dataclasses.dataclass(frozen=True, order=True)
class DesignPoint:
    """One concrete SoC configuration (hashable, totally ordered)."""
    num_big: int = 4
    num_little: int = 4
    num_scr: int = 2
    num_fft: int = 4
    num_vit: int = 0
    big_freq_ghz: float = BIG_FREQS[-1]
    little_freq_ghz: float = LITTLE_FREQS[-1]
    cross_cluster_penalty: float = 2.0

    @property
    def num_pes(self) -> int:
        return (self.num_big + self.num_little + self.num_scr
                + self.num_fft + self.num_vit)

    @property
    def area_mm2(self) -> float:
        return (self.num_big * AREA_MM2["big"]
                + self.num_little * AREA_MM2["little"]
                + self.num_scr * AREA_MM2["scr"]
                + self.num_fft * AREA_MM2["fft"]
                + self.num_vit * AREA_MM2["vit"])

    def is_valid(self) -> bool:
        """A design must keep at least one CPU (several tasks are CPU-only)."""
        return self.num_pes > 0 and (self.num_big + self.num_little) > 0

    def label(self) -> str:
        return (f"b{self.num_big}L{self.num_little}s{self.num_scr}"
                f"f{self.num_fft}v{self.num_vit}"
                f"@{self.big_freq_ghz:g}/{self.little_freq_ghz:g}"
                f"x{self.cross_cluster_penalty:g}")

    def to_db(self) -> ResourceDB:
        comm = CommModel(cross_cluster_penalty=self.cross_cluster_penalty)
        return make_soc(self.num_big, self.num_little, self.num_scr,
                        self.num_fft, self.num_vit, comm=comm)

    def soc_key(self) -> Tuple:
        """What :meth:`to_db` reads, the PE counts and the penalty: designs
        equal in it differ in their clocks alone and have equal databases."""
        return (self.num_big, self.num_little, self.num_scr, self.num_fft,
                self.num_vit, self.cross_cluster_penalty)

    def freq_caps(self) -> Dict[str, float]:
        """Per-type frequency caps — the design's hardware envelope, shared
        by the static userspace governor and the dynamic governors' OPP
        ladder truncation (one source for both backends)."""
        return {CPU_BIG: self.big_freq_ghz, CPU_LITTLE: self.little_freq_ghz}

    def governor(self) -> UserspaceGovernor:
        """Frequency caps as a userspace governor (static DVFS point)."""
        return UserspaceGovernor(self.freq_caps())


# Axis order is part of the public contract: grid() enumerates in this order
# and sampling strata are drawn per axis in this order — deterministic.
AXES: Tuple[str, ...] = (
    "num_big", "num_little", "num_scr", "num_fft", "num_vit",
    "big_freq_ghz", "little_freq_ghz", "cross_cluster_penalty",
)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Cartesian design space: allowed values per axis."""
    num_big: Tuple[int, ...] = (0, 1, 2, 4)
    num_little: Tuple[int, ...] = (0, 2, 4, 8)
    num_scr: Tuple[int, ...] = (0, 1, 2)
    num_fft: Tuple[int, ...] = (0, 2, 4)
    num_vit: Tuple[int, ...] = (0, 1)
    big_freq_ghz: Tuple[float, ...] = (1.4, 2.0)
    little_freq_ghz: Tuple[float, ...] = (1.0, 1.4)
    cross_cluster_penalty: Tuple[float, ...] = (2.0,)

    def axis_values(self) -> Dict[str, Tuple]:
        return {a: tuple(getattr(self, a)) for a in AXES}

    @property
    def size(self) -> int:
        """Cardinality of the hull (before validity/budget filtering)."""
        n = 1
        for a in AXES:
            n *= len(getattr(self, a))
        return n

    def _point(self, values: Sequence) -> DesignPoint:
        return DesignPoint(**dict(zip(AXES, values)))

    def contains(self, p: DesignPoint) -> bool:
        return all(getattr(p, a) in getattr(self, a) for a in AXES)

    # -- enumeration -------------------------------------------------------
    def grid(self, budget_mm2: Optional[float] = None) -> List[DesignPoint]:
        """Exhaustive deterministic enumeration (product order over AXES)."""
        out = []
        for values in itertools.product(*(getattr(self, a) for a in AXES)):
            p = self._point(values)
            if not p.is_valid():
                continue
            if budget_mm2 is not None and p.area_mm2 > budget_mm2:
                continue
            out.append(p)
        return out

    def sample_random(self, n: int, seed: int = 0,
                      budget_mm2: Optional[float] = None,
                      exclude: Sequence[DesignPoint] = ()) -> List[DesignPoint]:
        """n distinct valid points, uniform over the hull (seeded)."""
        rng = np.random.default_rng(seed)
        seen = set(exclude)
        out: List[DesignPoint] = []
        sizes = [len(getattr(self, a)) for a in AXES]
        for _ in range(max(64, 50 * n)):
            if len(out) >= n:
                break
            idx = [int(rng.integers(k)) for k in sizes]
            p = self._point([getattr(self, a)[i] for a, i in zip(AXES, idx)])
            if not p.is_valid() or p in seen:
                continue
            if budget_mm2 is not None and p.area_mm2 > budget_mm2:
                continue
            seen.add(p)
            out.append(p)
        if len(out) < n:
            # draw budget exhausted (tiny feasible region): fall back to the
            # exhaustive grid so the "min(n, feasible) points" contract holds
            pool = [p for p in self.grid(budget_mm2=budget_mm2)
                    if p not in seen]
            order = rng.permutation(len(pool))
            out += [pool[i] for i in order[:n - len(out)]]
        return out

    def sample_lhs(self, n: int, seed: int = 0,
                   budget_mm2: Optional[float] = None) -> List[DesignPoint]:
        """Latin-hypercube sample: every axis stratified into n bins, bins
        permuted independently per axis, then mapped onto the discrete values.
        Invalid/duplicate/over-budget draws are topped up with
        ``sample_random`` so exactly ``min(n, feasible)`` points return."""
        rng = np.random.default_rng(seed)
        cols = []
        for a in AXES:
            vals = getattr(self, a)
            strata = rng.permutation(n)                    # one bin per sample
            cols.append([vals[int(s * len(vals) // n)] for s in strata])
        seen = set()
        out: List[DesignPoint] = []
        for row in zip(*cols):
            p = self._point(row)
            if not p.is_valid() or p in seen:
                continue
            if budget_mm2 is not None and p.area_mm2 > budget_mm2:
                continue
            seen.add(p)
            out.append(p)
        if len(out) < n:
            out += self.sample_random(n - len(out), seed=seed + 1,
                                      budget_mm2=budget_mm2, exclude=out)
        return out

    # -- local moves (used by the evolutionary refinement loop) ------------
    def neighbors(self, p: DesignPoint) -> List[DesignPoint]:
        """All one-axis ±1-step moves from ``p`` that stay in the space."""
        out = []
        for a in AXES:
            vals = getattr(self, a)
            try:
                i = vals.index(getattr(p, a))
            except ValueError:
                continue
            for j in (i - 1, i + 1):
                if 0 <= j < len(vals):
                    q = dataclasses.replace(p, **{a: vals[j]})
                    if q.is_valid():
                        out.append(q)
        return out
