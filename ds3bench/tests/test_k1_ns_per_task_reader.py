"""The reader of ``k1_ns_per_task`` (``ds3bench/metrics/k1_ns_per_task.py``):
K1's device time over the traced calls' tasks, in ns, on a synthetic trace,
nothing where there is nothing to read, K1's time per call scaled by the
calls over the tasks, and a traced tiny run on the CPU (no K1 kernel there:
no value).  ``BENCHMARK.json`` does not list the metric yet (PERF.md §7).

    PYTHONPATH=src python -m pytest -q ds3bench/tests
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import ds3bench_tiny  # noqa: E402
from ds3bench.harness import profile, runner, spec  # noqa: E402

SEED = 2 ** 31 + 4242


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _read(run):
    return spec._reader(ROOT, "k1_ns_per_task")(run)


def _calls(tasks):
    return [runner.CallRecord(k, k + 1, n, 1, []) for k, n in enumerate(tasks)]


def test_k1_time_over_the_tasks_of_the_traced_calls():
    ev = [_event("user_annotation", "ds3bench.call", 0, 1000),
          _event("kernel", "void epoch_scan_kernel<true, false>(...)", 100, 400),
          _event("kernel", "elementwise", 600, 100),
          _event("user_annotation", "ds3bench.call", 1000, 1000),
          _event("kernel", "void epoch_scan_kernel<true, false>(...)", 1100, 600)]
    s = profile.summarize(ev)
    run = runner.RunRecord("c", 1.0, s.window_s, _calls([2_000, 3_000]), s)
    # 1,000 us of K1 over 5,000 tasks: 200 ns a task; the other kernel is
    # not K1's
    assert _read(run) == pytest.approx(200.0)
    # nothing to read: no trace, no K1 kernel, no task
    assert _read(runner.RunRecord("c", 1.0, 1.0, _calls([5]))) is None
    no_k1 = profile.summarize(ev[:1] + ev[2:4])
    assert _read(runner.RunRecord("c", 1.0, 1.0, _calls([5]), no_k1)) is None
    assert _read(runner.RunRecord("c", 1.0, 1.0, _calls([0, 0]), s)) is None


def test_k1_time_per_call_over_the_tasks_per_call():
    ev = [_event("user_annotation", "ds3bench.call", 0, 1000),
          _event("kernel", "void epoch_scan_kernel<true, false>(...)", 100, 300),
          _event("user_annotation", "ds3bench.call", 1000, 1000),
          _event("kernel", "void epoch_scan_kernel<false, false>(...)", 1100, 500),
          _event("kernel", "void epoch_scan_kernel<false, false>(...)", 1700, 200)]
    s = profile.summarize(ev)
    calls = _calls([4_000, 6_000])
    run = runner.RunRecord("c", 1.0, s.window_s, calls, s)
    per_call = spec._reader(ROOT, "k1_ms_per_call")(run)
    assert _read(run) == pytest.approx(1e6 * per_call * 2 / 10_000)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return ds3bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_a_traced_cpu_run_has_no_k1_kernel_to_read(tiny_root):
    prep = runner.prepare(tiny_root, "tiny-policy-sweep", SEED, "cpu")
    prep.entry.call(prep.jts[0])
    records, _, summary = runner._traced(prep, 2, "cpu")
    assert summary.calls == 2 and sum(r.tasks for r in records) > 0
    assert _read(runner.RunRecord("c", 1.0, summary.window_s, records,
                                  summary)) is None
