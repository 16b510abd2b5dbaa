"""The port's program spans (``repro_torch.obs.metrics.span``) on the CPU.

Off (no ``torch.profiler`` session): a span is the shared no-op; it calls
neither ``record_function`` nor ``torch.cuda.synchronize`` and leaves the
registry as it was.  Live: a static sweep with the ``table`` scheduler, a
DTPM sweep and an ``evaluate`` each export exactly one
``repro_torch.entry`` span, every layer span inside it, no layer span inside
another; the answers are the same bits with the profiler on and off.
"""
import importlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.dse import DesignPoint, evaluate
from repro_torch.obs import metrics
from repro_torch.scenario import Scenario, TraceSpec

sweep = importlib.import_module("repro_torch.scenario.sweep").sweep

JOBS = 20
BASE = Scenario(trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=JOBS, seed=3))
DESIGNS = [DesignPoint(), DesignPoint(num_little=2, num_fft=2)]
POLICIES = [(("sample_window_us", 50.0), ("up_threshold", 0.6)),
            (("sample_window_us", 100.0), ("up_threshold", 0.9))]
SPANS = (metrics.ENTRY,) + metrics.LAYER_SPANS


def static_sweep():
    return sweep(BASE, {"scheduler": ["etf", "table"], "rate": [5.0, 40.0]},
                 device="cpu")


def dtpm_sweep():
    return sweep(BASE.replace(governor="ondemand"),
                 {"design": DESIGNS, "governor_params": POLICIES,
                  "seed": [0, 1]}, device="cpu")


def dse_evaluate():
    traces = [BASE.with_seed(s).job_trace() for s in (0, 1)]
    return evaluate(DESIGNS, BASE.applications(), traces, policy="etf",
                    device="cpu")


CALLS = {
    "static sweep": (static_sweep, set(SPANS)),
    "dtpm sweep": (dtpm_sweep, set(SPANS) - {metrics.THERMAL}),
    "evaluate": (dse_evaluate, set(SPANS)),
}


def _answers(res):
    names = ("avg_latency_us", "makespan_us", "energy_j", "peak_temp_c",
             "busy_per_pe_us") if hasattr(res, "makespan_us") else (
        "latency_per_trace_us", "energy_per_trace_j", "temp_per_trace_c")
    return {n: np.asarray(getattr(res, n)) for n in names}


def _span_timers():
    return {n: t for n, t in metrics.snapshot()["timers"].items()
            if n in SPANS}


def _traced(fn, tmp_path):
    """``fn()`` under a CPU profiler: its result and the exported trace's
    program spans as (name, start, end), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("repro_torch."))
    return out, [(n, a, b) for a, b, n in spans]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_span_off_touches_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not metrics.profiling()
    before = _span_timers()
    for name in SPANS:
        with metrics.span(name):
            pass
    assert metrics.span(metrics.K1) is metrics.span(metrics.ENTRY)
    metrics.wait(torch.device("cuda"))
    static_sweep()
    assert _span_timers() == before
    assert obs.span is metrics.span


def test_a_live_span_adds_to_its_timer():
    t = metrics.timer(metrics.TABLES)
    n0, s0 = t.count, t.total_s
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.profiling()
        with metrics.span(metrics.TABLES):
            pass
        with metrics.span(metrics.ENTRY):
            with metrics.span(metrics.ENTRY):        # nested: counted once
                pass
    assert not metrics.profiling()
    assert t.count == n0 + 1 and t.total_s >= s0
    assert metrics._entries.depth == 0


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_of_each_entry_on_the_profilers_clock(call, tmp_path):
    fn, want = CALLS[call]
    entries0 = metrics.timer(metrics.ENTRY).count
    _, spans = _traced(fn, tmp_path)
    assert {n for n, _, _ in spans} == want
    entries = [s for s in spans if s[0] == metrics.ENTRY]
    assert len(entries) == 1                     # evaluate -> sweep: one
    assert metrics.timer(metrics.ENTRY).count == entries0 + 1
    layers = [s for s in spans if s[0] != metrics.ENTRY]
    assert all(_inside(s, entries[0]) for s in layers)
    for i, a in enumerate(layers):
        for b in layers[i + 1:]:
            assert not (_inside(a, b) or _inside(b, a)), (a, b)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_answers_the_same_with_the_profiler_on(call, tmp_path):
    fn, _ = CALLS[call]
    off = _answers(fn())
    on, _ = _traced(fn, tmp_path)
    on = _answers(on)
    assert off.keys() == on.keys()
    for k in off:
        assert np.array_equal(off[k], on[k]), k
