"""Named counters and timers + the run manifest, on the port.

The twin of ``src/repro/obs/metrics.py``: one process-wide registry of
plain-Python :class:`Counter` and :class:`Timer` objects (the same name
gives the same object), :func:`snapshot`, :func:`reset_all`,
:func:`scenario_hash`, and :func:`run_manifest`, the self-describing record
attached to every ``Result`` of ``scenario.run`` and every ``BENCH_*.json``
(``obs.bench``).  The reference's ``jit_compile_count`` has no twin: nothing
is traced here.  Where it stands, the manifest carries what the port counts
instead, K1's launches by instantiation and the sweep's grid scans.

Stdlib-only at import (``torch`` and the counted modules are imported inside
:func:`run_manifest`): the scenario and dse modules import this one for
their counters, so it must not import them back.
"""
from __future__ import annotations

import hashlib
import platform as _platform
import time
from typing import Dict, Optional

MANIFEST_SCHEMA = "repro.obs/manifest/v1"


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


def run_manifest(scenario=None, backend: Optional[str] = None, *,
                 device=None, **extra) -> Dict:
    """A self-describing record of one run: what ran, where, what launched.

    Fields: schema tag (the reference's), UTC timestamp, python, host
    platform, ``torch_version`` and ``cuda_version`` (``torch.version.cuda``,
    ``None`` in a CPU build); with ``device`` (the ``torch.device`` the run
    used, or its name) ``device_platform`` (``"gpu"`` or ``"cpu"``),
    ``device_kind`` (``torch.cuda.get_device_name`` of that device, or
    ``"cpu"``) and ``device_count`` (the process's CUDA devices, 1 for the
    CPU); ``k1_launches``, K1's launches by instantiation since the process
    started (``kernels.epoch_scan.variant_launches``, under the names of
    ``VARIANT_NAMES``), and ``scan_calls``, the grid scans ``sweep`` has
    started (``scenario.sweep.scan_calls``, the same names), where the
    reference has ``jit_compile_count``; the counter/timer snapshot; and,
    when given, the scenario's label and hash and the backend.  ``extra``
    key-values (wall times, bench name, ...) are merged verbatim.
    """
    import importlib
    from datetime import datetime, timezone

    import torch

    from ..kernels import epoch_scan
    # the module (the scenario package's `sweep` attribute is the function)
    scan_calls = importlib.import_module("..scenario.sweep",
                                         __package__).scan_calls
    man = {
        "schema": MANIFEST_SCHEMA,
        "timestamp": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "python": _platform.python_version(),
        "host_platform": _platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            man["device_platform"] = "gpu"
            man["device_kind"] = torch.cuda.get_device_name(dev)
            man["device_count"] = torch.cuda.device_count()
        else:
            man["device_platform"] = dev.type
            man["device_kind"] = dev.type
            man["device_count"] = 1
    if scenario is not None:
        man["scenario"] = scenario.label()
        man["scenario_hash"] = scenario_hash(scenario)
    if backend is not None:
        man["backend"] = backend
    names = epoch_scan.VARIANT_NAMES
    man["k1_launches"] = {names[k]: n
                          for k, n in epoch_scan.variant_launches.items()}
    man["scan_calls"] = {names[k]: n for k, n in scan_calls.items()}
    man["metrics"] = snapshot()
    man.update(extra)
    return man
