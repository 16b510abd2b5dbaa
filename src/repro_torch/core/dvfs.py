"""DVFS governors (paper §2: "built-in DVFS governors deployed on commercial
SoCs") — performance, powersave, userspace, ondemand, thermal throttle.

A governor controls the frequency of each CPU *cluster* (accelerators run at
fixed clocks).  ``ondemand`` mirrors the Linux governor: sample utilisation
over a window; if it exceeds ``up_threshold`` jump to f_max, otherwise step
down proportionally.  ``throttle`` is ondemand plus a thermal cap: when the
cluster's RC-model temperature exceeds the cap the cluster is clamped to its
lowest OPP for the next window.

**One policy, two kernels.**  The per-window transition is expressed once, in
array form, by :class:`GovernorPolicy` plus the pure step functions
:func:`ondemand_index` / :func:`throttle_index`.  The object-style governors
below are thin wrappers over those functions (``OndemandGovernor.update``
calls ``ondemand_index``), and the epoch-scan kernel is to run the *same*
transition on tensors, so ref and kernel governor semantics agree by
construction, not by parallel maintenance (DESIGN.md §7).  In this port the
policy is a plain frozen dataclass.  The epoch scan takes policies as
per-lane tensors (:func:`policy_lanes`) and runs the transition through the
tensor twins :func:`ondemand_index_torch` / :func:`throttle_index_torch`
(its CUDA kernel repeats them op for op); :func:`stack_policies` stacks a
sweep's G policies into such lanes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .resources import CPU_BIG, CPU_LITTLE, NOMINAL_FREQ, OPP_TABLE, ResourceDB

# Maximum OPP levels across CPU types — the K axis of every OPP-indexed table.
MAX_OPP_LEVELS = max(len(v) for v in OPP_TABLE.values())


def capped_levels(pe_type: str,
                  freq_caps: Optional[Mapping[str, float]]) -> List[float]:
    """The OPP ladder of ``pe_type`` truncated at a frequency cap.

    Design points carry per-cluster frequency caps; a dynamic governor's
    ladder stops at the cap (never below one level).  One definition feeds
    both the reference governor transition and ``build_tables``'s OPP-indexed
    ladders, so the two kernels agree on the capped OPP set by construction.
    """
    opps = [f for f, _ in OPP_TABLE[pe_type]]
    if freq_caps is not None and pe_type in freq_caps:
        capped = [f for f in opps if f <= freq_caps[pe_type] + 1e-9]
        opps = capped or opps[:1]
    return opps


def padded_ladder(pe_type: str,
                  freq_caps: Optional[Mapping[str, float]] = None):
    """``(levels, padded_row, count)`` for a capped ladder: ``padded_row``
    has ``MAX_OPP_LEVELS`` entries, ascending, top-padded by repeating the
    highest real level.  This padding convention is load-bearing for
    :func:`ondemand_index`'s first-covering argmax — every OPP table in the
    system (object governors, ``build_tables`` ladders, tests) must build
    through here.
    """
    opps = capped_levels(pe_type, freq_caps)
    row = opps + [opps[-1]] * (MAX_OPP_LEVELS - len(opps))
    return opps, row, len(opps)


# --------------------------------------------------------------------------
# Array-form policy — the representation both kernels execute
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GovernorPolicy:
    """Array-form DVFS policy: the per-window transition both kernels run.

    ``dynamic=False`` marks a static governor (performance / powersave /
    userspace): one OPP per cluster, fixed at table-build time — the epoch
    scan has no window machinery then.  ``dynamic=True`` is the
    ondemand family: every ``sample_window_us`` of simulated time each
    cluster's utilisation drives :func:`ondemand_index`, the window's
    realised power advances the §6 RC network by the exact update over
    ``thermal_dt_s`` seconds, and clusters hotter than ``thermal_cap_c`` are
    clamped to their lowest OPP (:func:`throttle_index`).

    ``thermal_dt_s`` decouples thermal from schedule time: each sampling
    window's power is held for ``thermal_dt_s`` of wall-clock, treating the
    window as representative of a sustained streaming workload (the same
    assumption as DESIGN.md §6's periodic steady state) — so second-scale
    thermal responses are explorable from millisecond traces.  The dataclass
    default is 50 µs (the default window); :class:`OndemandGovernor` ties it
    to its actual ``sample_window_us`` (real-time integration) unless
    overridden, so construct policies through a governor when in doubt.
    """
    dynamic: bool = False
    up_threshold: float = 0.80
    sample_window_us: float = 50.0
    thermal_cap_c: float = math.inf
    thermal_dt_s: float = 50.0e-6


def validate_policy_params(sample_window_us, up_threshold, thermal_dt_s):
    """Positivity checks every dynamic-policy entry point shares (governor
    constructor and the kernels' entry points).  Accepts scalars
    or arrays (stacked policy lanes)."""
    if not np.all(np.asarray(sample_window_us) > 0):
        raise ValueError("sample_window_us must be positive (a non-advancing "
                         "window would hang the kernel's window loop)")
    if not np.all(np.asarray(up_threshold) > 0):
        raise ValueError("up_threshold must be positive (zero would silently "
                         "pin clusters to fmin/fmax)")
    if not np.all(np.asarray(thermal_dt_s) > 0):
        raise ValueError("thermal_dt_s must be positive (dt=0 freezes the "
                         "RC state; dt<0 diverges it)")


def ondemand_index(opp_freq, num_opp, up_threshold, util, xp=np):
    """The ondemand transition on (C,) frequency domains — next OPP index.

    ``opp_freq``: (C, K) ascending per-domain OPP frequencies, rows padded by
    repeating the top level; ``num_opp``: (C,) real level counts;
    ``util``: (C,) window utilisation in [0, 1].  Above ``up_threshold`` jump
    to f_max; otherwise step down to the smallest OPP covering
    ``target = f_max · util / up_threshold``.  ``xp`` names the array
    module (numpy here).
    """
    opp_freq = xp.asarray(opp_freq)
    num_opp = xp.asarray(num_opp)
    util = xp.asarray(util)
    top = num_opp - 1
    fmax = xp.take_along_axis(opp_freq, top[:, None], axis=1)[:, 0]
    target = fmax * xp.maximum(util, 0.0) / up_threshold
    covers = opp_freq >= (target[:, None] - 1e-9)
    down = xp.argmax(covers, axis=1).astype(num_opp.dtype)
    return xp.where(util > up_threshold, top, down)


def throttle_index(idx, temp_c, thermal_cap_c, xp=np):
    """Thermal-throttle override: clamp hot domains to their lowest OPP.

    ``idx``: (C,) proposed OPP indices; ``temp_c``: (C,) each domain's RC
    node temperature *after* the window's exact-step update; an infinite cap
    disables the override.
    """
    return xp.where(xp.asarray(temp_c) > thermal_cap_c,
                    xp.zeros_like(idx), idx)


# the reference's ``target - 1e-9`` rounds the constant to float32 first
# (a weakly typed Python float meets f32 arrays): at any target above ~0.01
# it is lost, at util = 0 it is not
_COVER_SLACK = np.float32(1e-9)


def ondemand_index_torch(opp_freq: torch.Tensor, num_opp: torch.Tensor,
                         up_threshold: torch.Tensor,
                         util: torch.Tensor) -> torch.Tensor:
    """:func:`ondemand_index` on tensors, lanes first: ``opp_freq`` (C, K)
    f32 and ``num_opp`` (C,) int (one design's, or (L, C, K) and (L, C), each
    lane's design's), ``up_threshold`` (L,) f32, ``util`` (L, C) f32 ->
    (L, C) int64.  Float32 op by op in the reference's order:
    ``fmax * max(util, 0) / up``, then ``opp_freq >= target - f32(1e-9)``;
    the first covering level, or level 0 where none covers (argmax of an
    all-false row), as ``jnp.argmax`` gives."""
    top = num_opp.long() - 1                                     # ([L,] C)
    fmax = opp_freq.gather(-1, top[..., None])[..., 0]           # ([L,] C)
    up = up_threshold[:, None]
    target = fmax * torch.clamp(util, min=0.0) / up              # (L, C)
    # a fill on the device: a tensor copied from the host would synchronise
    slack = torch.full((), _COVER_SLACK, device=util.device)
    covers = opp_freq >= (target - slack)[..., None]             # (L, C, K)
    down = torch.argmax(covers.to(torch.int32), dim=-1)          # first True
    return torch.where(util > up, top, down)


def throttle_index_torch(idx: torch.Tensor, temp_c: torch.Tensor,
                         thermal_cap_c: torch.Tensor) -> torch.Tensor:
    """:func:`throttle_index` on tensors: ``idx`` and ``temp_c`` (L, C),
    ``thermal_cap_c`` (L,); an infinite cap disables the override."""
    return torch.where(temp_c > thermal_cap_c[:, None],
                       torch.zeros_like(idx), idx)


@dataclasses.dataclass(frozen=True)
class PolicyLanes:
    """Dynamic policies as per-lane float32 tensors on the host: what the
    DTPM epoch scan reads, the same values for its kernel and its plain
    version.  ``A_rc`` / ``B_rc`` (L, 4, 4) are the exact RC update over
    each lane's ``thermal_dt_s``."""
    window: torch.Tensor   # (L,) sample_window_us
    up: torch.Tensor       # (L,) up_threshold
    cap: torch.Tensor      # (L,) thermal_cap_c (inf: no throttle)
    A_rc: torch.Tensor     # (L, 4, 4)
    B_rc: torch.Tensor     # (L, 4, 4)

    @property
    def lanes(self) -> int:
        return int(self.window.shape[0])

    def take(self, index: torch.Tensor) -> "PolicyLanes":
        """The lanes ``index`` (a (L',) int tensor) picks, in its order."""
        return PolicyLanes(*(getattr(self, f.name)[index]
                             for f in dataclasses.fields(self)))


def stack_policies(policies: Sequence[GovernorPolicy]) -> PolicyLanes:
    """Stack G same-shape dynamic policies into (G,) lanes (the sweep's
    policy-lane axis; the twin of the reference's ``stack_policies``, which
    returns a policy with (G,) leaves).  Raises as the reference does for an
    empty list, a static policy, or a non-positive window, threshold or RC
    step."""
    if not policies:
        raise ValueError("empty policy list")
    if not all(p.dynamic for p in policies):
        raise ValueError("only dynamic policies batch; static governors are "
                         "compiled into the tables (DESIGN.md §7)")
    return policy_lanes(list(policies), len(policies))


def policy_lanes(policies, lanes: int) -> PolicyLanes:
    """One dynamic :class:`GovernorPolicy` for every lane, or a sequence of
    ``lanes`` of them, as :class:`PolicyLanes` on the host (a
    :class:`PolicyLanes` of ``lanes`` lanes passes as it is).  Raises for a
    static policy or a non-positive window, threshold or RC step, as the
    reference's ``simulate_jax_dtpm`` does.  The RC matrices are computed
    once per distinct ``thermal_dt_s`` by ``dse.thermal_torch.
    exact_step_matrices``, in float32 on the CPU."""
    from ..dse.thermal_torch import exact_step_matrices
    if isinstance(policies, PolicyLanes):
        if policies.lanes != lanes:
            raise ValueError(f"{policies.lanes} policy lanes for {lanes} lanes")
        return policies
    pols = ([policies] * lanes if isinstance(policies, GovernorPolicy)
            else list(policies))
    if len(pols) != lanes:
        raise ValueError(f"{len(pols)} policies for {lanes} lanes")
    if not all(p.dynamic for p in pols):
        raise ValueError("static governors bake into the tables; use "
                         "simulate_torch (DESIGN.md §7)")
    validate_policy_params([p.sample_window_us for p in pols],
                           [p.up_threshold for p in pols],
                           [p.thermal_dt_s for p in pols])
    dts = [float(np.float32(p.thermal_dt_s)) for p in pols]
    rc = {dt: exact_step_matrices(torch.tensor(dt, dtype=torch.float32))
          for dt in set(dts)}
    f32 = lambda xs: torch.tensor(np.asarray(xs, np.float32))
    return PolicyLanes(
        window=f32([p.sample_window_us for p in pols]),
        up=f32([p.up_threshold for p in pols]),
        cap=f32([p.thermal_cap_c for p in pols]),
        A_rc=torch.stack([rc[dt][0] for dt in dts]),
        B_rc=torch.stack([rc[dt][1] for dt in dts]))


# --------------------------------------------------------------------------
# Object-style governors (thin wrappers over the array-form policy)
# --------------------------------------------------------------------------

class Governor:
    name = "base"

    def initial_freq(self, pe_type: str) -> float:
        raise NotImplementedError

    def update(self, pe_type: str, cur_freq: float, utilization: float) -> float:
        """Return the new cluster frequency given window utilisation in [0,1]."""
        return cur_freq

    def policy(self) -> GovernorPolicy:
        """The array-form transition this governor implements (static here)."""
        return GovernorPolicy(dynamic=False)


class PerformanceGovernor(Governor):
    name = "performance"

    def initial_freq(self, pe_type: str) -> float:
        return OPP_TABLE[pe_type][-1][0]


class PowersaveGovernor(Governor):
    name = "powersave"

    def initial_freq(self, pe_type: str) -> float:
        return OPP_TABLE[pe_type][0][0]


class UserspaceGovernor(Governor):
    name = "userspace"

    def __init__(self, freq_ghz: Dict[str, float] | float = 1.0):
        self._freq = freq_ghz

    def initial_freq(self, pe_type: str) -> float:
        if isinstance(self._freq, dict):
            return self._freq[pe_type]
        return float(self._freq)


class OndemandGovernor(Governor):
    """Linux-style ondemand: sampling window + up-threshold.

    ``thermal_cap_c`` (default: uncapped) arms the thermal-throttle override;
    ``thermal_dt_s`` sets the RC integration step per window (defaults to the
    window itself — see :class:`GovernorPolicy`).  ``freq_caps`` (pe_type →
    max GHz, usually attached from the design point by
    ``Scenario.make_governor``) truncates the OPP ladder the transition
    ranges over — the hardware envelope dynamic policies must respect.
    """
    name = "ondemand"

    def __init__(self, up_threshold: float = 0.80,
                 sample_window_us: float = 50.0,
                 thermal_cap_c: float = math.inf,
                 thermal_dt_s: Optional[float] = None):
        self.up_threshold = up_threshold
        self.sample_window_us = sample_window_us
        self.thermal_cap_c = thermal_cap_c
        self.thermal_dt_s = (float(thermal_dt_s) if thermal_dt_s is not None
                             else sample_window_us * 1e-6)
        validate_policy_params(sample_window_us, up_threshold,
                               self.thermal_dt_s)
        self.freq_caps: Optional[Mapping[str, float]] = None
        self._ladders: Dict = {}       # (pe_type, caps) -> padded arrays

    def _ladder(self, pe_type: str):
        key = (pe_type, tuple(sorted(self.freq_caps.items()))
               if self.freq_caps else None)
        hit = self._ladders.get(key)
        if hit is None:
            opps, row, n = padded_ladder(pe_type, self.freq_caps)
            hit = self._ladders[key] = (opps, np.asarray([row]),
                                        np.asarray([n]))
        return hit

    def initial_freq(self, pe_type: str) -> float:
        return self._ladder(pe_type)[0][0]

    def update(self, pe_type: str, cur_freq: float, utilization: float) -> float:
        opps, row, num = self._ladder(pe_type)
        idx = ondemand_index(row, num, self.up_threshold,
                             np.asarray([float(utilization)]))
        return float(opps[int(idx[0])])

    def policy(self) -> GovernorPolicy:
        return GovernorPolicy(dynamic=True,
                              up_threshold=float(self.up_threshold),
                              sample_window_us=float(self.sample_window_us),
                              thermal_cap_c=float(self.thermal_cap_c),
                              thermal_dt_s=float(self.thermal_dt_s))


class ThrottleGovernor(OndemandGovernor):
    """Ondemand with the thermal cap armed by default: the closed DTPM loop
    (utilisation *and* temperature feed back into frequency)."""
    name = "throttle"

    def __init__(self, up_threshold: float = 0.80,
                 sample_window_us: float = 50.0,
                 thermal_cap_c: float = 60.0,
                 thermal_dt_s: Optional[float] = 0.05):
        super().__init__(up_threshold, sample_window_us, thermal_cap_c,
                         thermal_dt_s)


GOVERNORS = {
    "performance": PerformanceGovernor,
    "powersave": PowersaveGovernor,
    "userspace": UserspaceGovernor,
    "ondemand": OndemandGovernor,
    "throttle": ThrottleGovernor,
}


def get_governor(name: str, **kw) -> Governor:
    try:
        return GOVERNORS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown governor {name!r}; have {sorted(GOVERNORS)}")
