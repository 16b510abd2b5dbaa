"""Named counters and timers + the run manifest, on the port.

The twin of ``src/repro/obs/metrics.py``: one process-wide registry of
plain-Python :class:`Counter` and :class:`Timer` objects (the same name
gives the same object), :func:`snapshot`, :func:`reset_all`,
:func:`scenario_hash`, and :func:`run_manifest`, the self-describing record
attached to every ``Result`` of ``scenario.run`` and every ``BENCH_*.json``
(``obs.bench``).  The reference's ``jit_compile_count`` has no twin: nothing
is traced here.  Where it stands, the manifest carries what the port counts
instead, K1's launches by instantiation and the sweep's grid scans.

Program spans (:func:`span`, :func:`spanned`, :func:`wait`) mark the layers
of ``sweep`` and ``evaluate`` on the profiler's clock.  A span is live only
while a ``torch.profiler`` session records in this process: it is then a
``record_function`` range (a ``user_annotation`` of the exported trace) and
its host interval adds to :func:`timer` of its name.  Otherwise it is a
shared no-op: no ``record_function``, no registry entry, no synchronise.

Stdlib-only at import (``torch`` and the counted modules are imported inside
:func:`run_manifest` and at a span's first check): the scenario and dse
modules import this one for their counters, so it must not import them back.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import platform as _platform
import threading
import time
from typing import Callable, Dict, Optional

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

    def at_least(self, n: int) -> int:
        """Raise the value to ``n`` where it is below (a running peak)."""
        self._value = max(self._value, n)
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
        self.add(time.perf_counter() - self._t0)
        return False

    def add(self, seconds: float) -> None:
        """Count one interval timed elsewhere (a live span's)."""
        self.last_s = seconds
        self.total_s += seconds
        self.count += 1

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


# -- program spans ------------------------------------------------------------

#: the outermost public call (``scenario.sweep``, ``dse.evaluate``,
#: ``dse.build_design_batch``): one span, however deep the calls nest
ENTRY = "repro_torch.entry"
#: the layers inside an entry; no two of them nest
TABLES = "repro_torch.tables"          # design tables built and stacked
K1 = "repro_torch.k1"                  # K1's wrapper: checks, host reads, launch
EPILOGUE = "repro_torch.epilogue"      # latency, energy, busy time of the scan
THERMAL = "repro_torch.thermal"        # the thermal grid: K6's wrapper and launch
WAIT = "repro_torch.wait"              # the host blocked on the card
LAYER_SPANS = (TABLES, K1, EPILOGUE, THERMAL, WAIT)

_OFF = contextlib.nullcontext()
_profiling: Optional[Callable[[], bool]] = None
_entries = threading.local()       # .depth: public calls in flight, a thread


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process (~0.1
    us; ``torch`` is read at the first call)."""
    global _profiling
    if _profiling is None:
        import torch
        _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


class _Span:
    """A live span: a ``record_function`` range, its host interval added to
    the registry's timer of its name."""
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        from torch.profiler import record_function
        self.name = name
        self._range = record_function(name)

    def __enter__(self) -> None:
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        timer(self.name).add(time.perf_counter() - self._t0)
        return self._range.__exit__(*exc)


class _Entry:
    """A live :data:`ENTRY`: a span at the outermost public call, a depth
    count in the calls it makes."""
    __slots__ = ("_span",)

    def __enter__(self) -> None:
        depth = getattr(_entries, "depth", 0)
        self._span = _Span(ENTRY) if depth == 0 else _OFF
        _entries.depth = depth + 1
        self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        _entries.depth -= 1
        return bool(self._span.__exit__(*exc))


def span(name: str):
    """The span ``name`` as a context manager: live under a profiler (see
    the module's docstring), else the shared no-op."""
    if not profiling():
        return _OFF
    return _Entry() if name == ENTRY else _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside :func:`span`
    ``(name)`` (off, the call goes straight through)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not profiling():
                return fn(*args, **kw)
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def wait(device, stream=None) -> None:
    """Live only: the host waits for ``device`` (for ``stream`` alone where
    given) inside the span :data:`WAIT`, so that the copy to the host that
    follows finds its data ready.  Off, nothing: the copy waits by itself."""
    if not profiling():
        return
    import torch
    with _Span(WAIT):
        if stream is not None:
            stream.synchronize()
        elif torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


# -- the tables layer ----------------------------------------------------------

#: designs whose tables ``core.simkernel_torch.build_table_stack`` built
DESIGNS_BUILT = "tables.designs_built"
#: the PE kinds it computed latency and power for (a kind serves every slot
#: of its profiles, type, clock and ladder, in every design of a build)
PE_KINDS = "tables.pe_kinds"


# -- the sweep's grid scans -----------------------------------------------------

#: grid scans started by ``scenario.sweep``, by program (DTPM, FAULTS) as
#: ``kernels.epoch_scan.variant_launches`` is keyed; their sum stands where
#: the reference's ``compile_count`` stands (one per scheduler value and
#: policy shape, and per block under ``chunk=`` or ``shard``; lanes add
#: none).  Counted by ``scenario.shardexec.grid_program``.
scan_calls = dict.fromkeys(((False, False), (True, False), (False, True),
                            (True, True)), 0)


# -- K1's live window ----------------------------------------------------------

#: the most jobs any lane of a K1 launch held live
K1_LIVE_PEAK = "k1_live_jobs_peak"
#: the lanes whose live jobs left the ring in shared memory
K1_OVERFLOW = "k1_overflow_lanes"
_k1_live: list = []


def k1_live(live, slots: int) -> None:
    """Called by K1's wrapper after a launch made while a profiler records:
    ``live`` (L,) on the card, the most jobs each lane of the launch held,
    kept until :func:`run_manifest` reads it into :data:`K1_LIVE_PEAK` and
    :data:`K1_OVERFLOW` (the lanes above the ring's ``slots``)."""
    _k1_live.append((live, slots))


def _read_k1_live() -> None:
    """The counts handed over so far, once every card they lie on has
    finished its work (a launch on another stream or card may still be
    writing them)."""
    if not _k1_live:
        return
    import torch
    for dev in {live.device for live, _ in _k1_live}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    while _k1_live:
        live, slots = _k1_live.pop(0)
        if live.numel():
            counter(K1_LIVE_PEAK).at_least(int(live.max()))
            counter(K1_OVERFLOW).inc(int((live > slots).sum()))


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
    started (:data:`scan_calls`, the same names), where the
    reference has ``jit_compile_count``; ``k1_live_jobs_peak`` and
    ``k1_overflow_lanes``, the most jobs a lane of K1 held and the lanes
    whose live jobs left the ring, over the card launches made while a
    profiler recorded (:func:`k1_live`, read here after a synchronise of
    each card; 0 otherwise); ``thermal_launches``,
    the thermal grid's kernel launches (the registry counter of that name);
    ``tables.designs_built`` and ``tables.pe_kinds``, the designs the tables
    builder built and the PE kinds it computed them from; the
    counter/timer snapshot; and,
    when given, the scenario's label and hash and the backend.  ``extra``
    key-values (wall times, bench name, ...) are merged verbatim.
    """
    from datetime import datetime, timezone

    import torch

    from ..kernels import epoch_scan
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
    _read_k1_live()
    man[K1_LIVE_PEAK] = counter(K1_LIVE_PEAK).value
    man[K1_OVERFLOW] = counter(K1_OVERFLOW).value
    man["scan_calls"] = {names[k]: n for k, n in scan_calls.items()}
    man["thermal_launches"] = counter("thermal_launches").value
    for name in (DESIGNS_BUILT, PE_KINDS):
        man[name] = counter(name).value
    man["metrics"] = snapshot()
    man.update(extra)
    return man
