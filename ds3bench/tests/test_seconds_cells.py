"""The two DTPM cells of longer chains on the CPU: ``dtpm-seconds-sweep``
(16 ondemand policies x 64 traces of 40,000 jobs at 20 jobs/ms on the
Table-2 SoC: 2 s a lane) and ``dtpm-policy-sweep-met`` (the DTPM policy
sweep under MET).  Each is found by name with its metrics; the seconds
cell's call is 1,024 lanes of 40,000 jobs in one DTPM scan of one design of
15 PEs; tiny copies of both, data files alone (built as ``ds3bench_tiny``
builds its own), run traced and untraced on the port's CPU path, equal the
reference lane by lane, and the bfloat16 control fails their limits.

    PYTHONPATH=src python -m pytest -q ds3bench/tests
"""
from __future__ import annotations

import io
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import ds3bench_tiny  # noqa: E402
from ds3bench.harness import check, entries, inputs, runner, spec  # noqa: E402
from ds3bench.reference import tasks_per_job  # noqa: E402

SEED = 2 ** 31 + 35
CELLS = ("dtpm-seconds-sweep", "dtpm-policy-sweep-met")
TINY = {"tiny-seconds-sweep": "dtpm-seconds-sweep",
        "tiny-policy-sweep-met": "dtpm-policy-sweep-met"}


@pytest.mark.parametrize("cell", CELLS)
def test_found_by_name_with_their_metrics(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.chips == 1 and c.traffic["entry"] == "sweep"
    assert set(c.limits) == {"latency", "makespan", "energy", "busy", "temp"}
    assert c.config["precision"] == "float32"
    assert {m.name for m in c.end_to_end} == {"sim_tasks_per_s", "setup_s"}
    names = {m.name for m in c.per_layer}
    assert {"k1_ms_per_call", "k1_roofline",
            "launches_per_call", "device_idle_pct", "host_wait_ms_per_call",
            "k1_host_ms_per_call"} <= names
    assert not names & {"tables_ms_per_call", "thermal_host_ms_per_call"}


def test_the_seconds_cell_is_one_design_under_16_policies_for_2_s():
    c = spec.load_cell(ROOT, "dtpm-seconds-sweep")
    cfg, tr = c.config, c.traffic
    assert cfg["governors"] == {"table2": "ondemand"}
    assert cfg["designs"]["table2"] == [[4, 4, 2, 4, 1, 2.0, 1.4, 2.0]]
    assert cfg["policies"] == spec.load_cell(
        ROOT, "dtpm-policy-sweep").config["policies"]
    assert cfg["reduced"] == ["horizon_s"] and cfg["horizon_s"] == 2.0
    traces = inputs.trace_set(tr["traces"], len(cfg["apps"]), SEED, 0)
    assert len(traces) == 64
    # 40,000 jobs at 20 jobs/ms: 2 s of arrivals
    assert all(1.9e6 < t.arrival_us[-1] < 2.1e6 for t in traces)
    entry = entries.make(cfg, tr, "cpu")
    lanes = entry.lanes(traces)
    assert len(lanes) == 1024 and entry.shape(traces) == (16, 64)
    assert {l.scheduler for l in lanes} == {"etf"}
    assert len({tuple(sorted(l.params.items())) for l in lanes}) == 16
    (launch,) = entry.launches(traces)
    assert (launch.dtpm, launch.D, launch.L, launch.J, launch.A, launch.T,
            launch.P) == (True, 1, 1024, 40_000, 5, 8, 15)
    per = inputs.tasks(traces, tasks_per_job(cfg["apps"]))
    assert 2.6e8 < 16 * per.sum() < 3.0e8          # ~2.8e8 tasks a call


def test_the_met_cell_is_the_policy_sweep_under_met():
    met = spec.load_cell(ROOT, "dtpm-policy-sweep-met")
    etf = spec.load_cell(ROOT, "dtpm-policy-sweep")
    assert met.config == etf.config
    assert {k: v for k, v in met.traffic.items() if k != "about"} == dict(
        {k: v for k, v in etf.traffic.items() if k != "about"},
        scheduler="met")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-like root with tiny copies of both cells, made by
    ``ds3bench_tiny.make_root`` with its cells swapped for these."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ds3bench_tiny, "TINY", TINY)
    try:
        yield ds3bench_tiny.make_root(tmp_path_factory.mktemp("bench"))
    finally:
        mp.undo()


def _run(root, cell, trace):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run_cell(root, cell, SEED, 0.0, trace, device="cpu",
                         out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_copies_run_and_are_correct(tiny_root, cell):
    for trace in (False, True):
        rc, res, err = _run(tiny_root, cell, trace)
        assert rc == 0 and res["correct"], err
        assert res["failed"] == 0 and res["attempted"] > 0
        if not trace:
            assert set(res["metrics"]) == {"sim_tasks_per_s", "setup_s"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_copies_equal_the_reference(tiny_root, cell):
    """Every lane of a tiny call against the reference: the makespan to the
    bit, the sums to float32 rounding; the control fails the limits."""
    prep = runner.prepare(tiny_root, cell, SEED, "cpu")
    _, outs, _ = runner.timed_calls(prep, 0.0, "cpu")
    i, out = outs[0]
    worst = check.widest([
        check.gaps(entries.lane_answers(out, prep.shape, n),
                   check.reference(prep.cell.config, lane,
                                   prep.sets[i][lane.trace]))
        for n, lane in enumerate(prep.lanes[i])])
    assert worst["makespan"] == 0.0
    for k in ("latency", "energy", "busy"):
        assert worst[k] < 1e-6, (k, worst)
    assert worst["temp"] < 1e-2
    control = check.widest(runner.sampled_gaps(prep, outs, SEED,
                                               precision="bfloat16"))
    assert not check.judge(control, prep.cell.limits)
