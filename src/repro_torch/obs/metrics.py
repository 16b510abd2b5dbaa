"""Named counters and timers, on the port.

The twin of the JAX-free part of ``src/repro/obs/metrics.py``: one
process-wide registry of plain-Python :class:`Counter` and :class:`Timer`
objects (the same name gives the same object), :func:`snapshot`,
:func:`reset_all` and :func:`scenario_hash`.  ``run_manifest`` and
``jit_compile_count`` read JAX in the reference and come with the rest of
``repro_torch.obs`` (ROADMAP.md queue 1, item 9); the sweep's scan count
stays ``repro_torch.scenario.sweep.scan_calls``.

Stdlib-only: the scenario and dse modules import it for their counters, so
it must not import them back.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, Optional


class Counter:
    """A named monotonic counter (``.value`` / ``.inc()`` / ``.reset()``)."""
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def inc(self, n: int = 1) -> int:
        self._value += n
        return self._value

    def reset(self) -> None:
        self._value = 0

    def __int__(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Timer:
    """A reusable wall-clock timer (``time.perf_counter``) context manager.

    ``with t: ...`` accumulates into ``total_s``/``count`` and exposes the
    most recent interval as ``last_s``.  It reads the host clock only: time
    on a CUDA device needs a synchronise inside the block.
    """
    __slots__ = ("name", "count", "total_s", "last_s", "_t0")

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.last_s = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.last_s = time.perf_counter() - self._t0
        self.total_s += self.last_s
        self.count += 1
        return False

    @property
    def last_us(self) -> float:
        return self.last_s * 1e6

    @property
    def avg_s(self) -> float:
        return self.total_s / max(self.count, 1)

    def __repr__(self) -> str:
        return (f"Timer({self.name}: n={self.count}, "
                f"total={self.total_s:.6f}s, last={self.last_s:.6f}s)")


_COUNTERS: Dict[str, Counter] = {}
_TIMERS: Dict[str, Timer] = {}


def counter(name: str) -> Counter:
    """The registered counter ``name`` (created on first use)."""
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = Counter(name)
    return c


def timer(name: str) -> Timer:
    """The registered timer ``name`` (created on first use)."""
    t = _TIMERS.get(name)
    if t is None:
        t = _TIMERS[name] = Timer(name)
    return t


def snapshot() -> Dict[str, Dict[str, float]]:
    """JSON-ready registry state: counter values + timer totals."""
    return {
        "counters": {n: c.value for n, c in sorted(_COUNTERS.items())},
        "timers": {n: {"count": t.count, "total_s": t.total_s,
                       "last_s": t.last_s}
                   for n, t in sorted(_TIMERS.items())},
    }


def reset_all() -> None:
    for c in _COUNTERS.values():
        c.reset()
    for t in _TIMERS.values():
        t.reset()


def scenario_hash(scenario) -> str:
    """Stable short hash of a frozen Scenario (its dataclass repr is
    deterministic), usable to correlate runs across processes/artifacts."""
    return hashlib.sha1(repr(scenario).encode()).hexdigest()[:12]
