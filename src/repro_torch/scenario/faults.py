"""Fail-stop fault specification and dense fault plans (DESIGN.md §14).

:class:`FaultSpec` is the declarative form of one fail-stop event: PE
``pe_id`` dies permanently at ``fail_time_us``.  Like every scenario
sub-spec (§9) it is frozen and hashable, so a ``Scenario`` carrying faults
still keys the table cache.

The kernels consume faults in two forms:

* the reference kernel takes the ``(pe_id, fail_time_us)`` pairs directly
  (last one wins per PE, matching its historical dict semantics);
* the epoch scan takes a dense **fault plan** — a ``(P,)`` float32 vector of
  fail times, ``+inf`` meaning "never fails" — or stacked ``(L, P)`` lane
  plans (:func:`stack_fault_plans`), one per lane of a batch, with the scan
  length :func:`fault_scan_steps` bounds.

``fail_time_us`` is quantised to float32 at construction so the reference
kernel's python-float comparisons and the scan's f32 comparisons agree
bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from .errors import ScenarioError

FAULT_KINDS = ("fail_stop",)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fail-stop event: PE ``pe_id`` dies permanently at ``fail_time_us``.

    Tasks in flight or queued on the PE at that moment (and their already
    committed descendants) are rolled back and re-scheduled on the surviving
    PEs; ``fail_time_us=inf`` never fires (a no-op).  ``kind`` is reserved
    for future fault models; only ``"fail_stop"`` exists today.
    """
    pe_id: int
    fail_time_us: float
    kind: str = "fail_stop"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ScenarioError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")
        pe = int(self.pe_id)
        if pe < 0:
            raise ScenarioError(f"fault pe_id must be >= 0, got {pe}")
        t = float(np.float32(self.fail_time_us))
        if np.isnan(t):
            raise ScenarioError("fault fail_time_us must not be NaN")
        object.__setattr__(self, "pe_id", pe)
        object.__setattr__(self, "fail_time_us", t)

    @property
    def is_noop(self) -> bool:
        """True when the event can never fire (infinite fail time)."""
        return not np.isfinite(self.fail_time_us)


def normalize_failures(failures) -> Tuple[FaultSpec, ...]:
    """Canonicalise a failures field to a tuple of :class:`FaultSpec`.

    Accepts the pre-FaultSpec bare ``(pe_id, fail_time_us)`` pairs through a
    one-release ``DeprecationWarning`` shim (the §9 ``*_mj`` playbook).
    """
    if failures is None:
        return ()
    out = []
    warned = False
    for f in failures:
        if isinstance(f, FaultSpec):
            out.append(f)
            continue
        pe_id, fail_time_us = f            # legacy (pe_id, fail_time_us)
        if not warned:
            warnings.warn(
                "bare (pe_id, fail_time_us) failure tuples are deprecated; "
                "pass repro_torch.scenario.FaultSpec(pe_id=..., fail_time_us=...) "
                "(this shim lasts one release)",
                DeprecationWarning, stacklevel=3)
            warned = True
        out.append(FaultSpec(pe_id=pe_id, fail_time_us=fail_time_us))
    return tuple(out)


def ref_failures(failures: Sequence[FaultSpec]
                 ) -> Optional[Sequence[Tuple[int, float]]]:
    """The ``(pe_id, fail_time_us)`` pair list the reference kernel takes
    (``None`` when nothing can fire, keeping its fault-free fast path)."""
    pairs = [(f.pe_id, f.fail_time_us) for f in normalize_failures(failures)
             if not f.is_noop]
    return pairs or None


def fault_plan(failures: Sequence[FaultSpec], num_pes: int,
               width: Optional[int] = None) -> Optional[np.ndarray]:
    """The dense ``(P,)`` f32 fail-time plan the epoch scan consumes.

    ``+inf`` marks PEs that never fail; duplicate ``pe_id`` entries resolve
    last-wins (the reference kernel's dict semantics).  ``pe_id`` validates
    against ``num_pes`` (the narrowest real design the plan must apply to);
    ``width`` (default ``num_pes``) sets the vector length — the padded PE
    width of a stacked design batch.  Returns ``None`` when no event can
    ever fire — empty specs and all-``inf`` specs normalise to the
    fault-free fast path, never changing the compiled program (the §14
    no-op contract).
    """
    plan = np.full(width or num_pes, np.inf, np.float32)
    fired = False
    for f in normalize_failures(failures):
        if f.pe_id >= num_pes:
            raise ScenarioError(
                f"fault pe_id={f.pe_id} out of range for a {num_pes}-PE "
                f"design (valid ids: 0..{num_pes - 1})")
        plan[f.pe_id] = np.float32(f.fail_time_us)
        fired = fired or not f.is_noop
    return plan if fired else None


def stack_fault_plans(fault_sets: Sequence[Sequence[FaultSpec]],
                      num_pes: int, width: Optional[int] = None
                      ) -> Tuple[Optional[np.ndarray], int]:
    """Stacked ``(F, P)`` lane plans, one per fault set.

    Returns ``(plans, max_faults)`` where ``max_faults`` is the widest
    finite-fault count across lanes (it bounds the extra scan steps every
    lane may need).  ``plans`` is ``None`` when every lane is a no-op: the
    lanes then take the exact fault-free program.
    """
    width = width or num_pes
    rows = [fault_plan(fs, num_pes, width) for fs in fault_sets]
    if all(r is None for r in rows):
        return None, 0
    plans = np.stack([np.full(width, np.inf, np.float32) if r is None
                      else r for r in rows])
    max_faults = int(np.isfinite(plans).sum(axis=1).max())
    return plans, max_faults


def fault_scan_steps(num_jobs: int, t_max: int, max_faults: int) -> int:
    """Epoch-scan length under ``max_faults`` fail-stop events.

    Each fault can roll back every committed task (≤ J·T re-commits) and
    costs at most one skipped epoch, so ``J·T·(1 + F) + F`` steps always
    suffice (DESIGN.md §14)."""
    return num_jobs * t_max * (1 + max_faults) + max_faults


def pe_loss_faults(pe_ids: Iterable[int], fail_time_us: float = 0.0,
                   k: int = 1) -> Tuple[Tuple[FaultSpec, ...], ...]:
    """Every k-subset of ``pe_ids`` failing at ``fail_time_us`` — the
    degraded-mode lane axis ``dse.evaluate(faults=...)`` ranks designs
    under (k-PE-loss resilience, DESIGN.md §14)."""
    return tuple(
        tuple(FaultSpec(pe_id=p, fail_time_us=fail_time_us) for p in combo)
        for combo in itertools.combinations(sorted(set(int(p) for p in pe_ids)), k))
