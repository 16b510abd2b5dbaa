"""Fail-stop faults in the plain reference and the harness (``ds3bench/``).

The reference's answers without faults, and with faults that never fire,
are the ones ``fault_free_answers.json`` holds: written by the reference as
it stood before it took faults, for set 1 of seed ``SEED`` of every tiny
copy ``ds3bench_tiny`` builds of the five real cells.  A fault lane equals
the port's CPU sweep with the same ``faults`` axis; a fault fired twice,
or one past the makespan, changes nothing; the harness hands the ``table``
scheduler's refusal of faults on, and counts K1's fault bytes only where a
set fires.

    PYTHONPATH=src python -m pytest -q ds3bench/tests
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import ds3bench_tiny  # noqa: E402
from ds3bench.harness import check, entries, inputs, runner, spec  # noqa: E402
from ds3bench.reference import Design, simulate_lane  # noqa: E402

SEED = 2 ** 31 + 39
APPS = ["wifi_tx", "wifi_rx", "single_carrier", "range_detection",
        "pulse_doppler"]
TABLE2 = (4, 4, 2, 4, 1, 2.0, 1.4, 2.0)
ONDEMAND = {"up_threshold": 0.7, "sample_window_us": 50.0}
# every tiny copy of the five real cells
COPIES = dict(ds3bench_tiny.TINY, **{
    "tiny-seconds-sweep": "dtpm-seconds-sweep",
    "tiny-policy-sweep-met": "dtpm-policy-sweep-met"})
WANT = json.loads((Path(__file__).parent / "fault_free_answers.json")
                  .read_text())


@pytest.fixture(scope="module")
def copies_root(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ds3bench_tiny, "TINY", COPIES)
    try:
        yield ds3bench_tiny.make_root(tmp_path_factory.mktemp("copies"))
    finally:
        mp.undo()


def _hex(res):
    return [float(res.avg_latency_us).hex(), float(res.makespan_us).hex(),
            float(res.energy_j).hex(), float(res.peak_temp_c).hex(),
            [float(b).hex() for b in res.busy_per_pe_us]]


def _lane(lane, trace, config, faults):
    th = config.get("thermal", {})
    return simulate_lane(Design(*lane.design), config["apps"],
                         trace.arrival_us, trace.app_index, lane.scheduler,
                         lane.governor, lane.params, bins=th.get("bins", 32),
                         repeats=th.get("repeats", 3), faults=faults)


@pytest.mark.parametrize("faults", ["none", "never"])
@pytest.mark.parametrize("cell", sorted(COPIES))
def test_without_a_fault_that_fires_the_answers_are_as_before(
        copies_root, cell, faults):
    prep = runner.prepare(copies_root, cell, SEED, "cpu")
    got = []
    for lane in prep.lanes[1]:
        pes = Design(*lane.design).soc().num_pes
        fs = () if faults == "none" else tuple((p, math.inf)
                                               for p in range(pes))
        got.append(_hex(_lane(lane, prep.sets[1][lane.trace],
                              prep.cell.config, fs)))
    assert got == WANT[cell]


def _traces(seed, n, jobs, rate):
    rng = np.random.default_rng(seed)
    return [inputs.poisson(rng, rate, jobs, len(APPS)) for _ in range(n)]


@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_a_fault_lane_equals_the_ports_cpu_sweep(governor):
    """One, two and three PEs lost at times drawn across the arrivals, under
    ETF and MET: every lane of the port's CPU sweep against the reference,
    the makespan to the bit, the sums within 1e-6."""
    from repro_torch.core.jobgen import JobTrace
    from repro_torch.dse.space import DesignPoint
    from repro_torch.scenario import FaultSpec, Scenario, sweep
    traces = _traces(SEED % 1000, 2, 80, 30.0)
    rng = np.random.default_rng(7)
    span = float(traces[0].arrival_us[-1])
    sets = [()] + [tuple((int(p), float(rng.uniform(0.1, 0.9) * span))
                         for p in rng.choice(15, size=k, replace=False))
                   for k in (1, 1, 1, 2, 3)]
    axes = {"scheduler": ["etf", "met"],
            "faults": [tuple(FaultSpec(pe_id=p, fail_time_us=t)
                             for p, t in fs) for fs in sets],
            "trace": [JobTrace(t.arrival_us, t.app_index, tuple(APPS))
                      for t in traces]}
    params = ONDEMAND if governor == "ondemand" else None
    if params:
        axes["governor_params"] = [tuple(sorted(params.items()))]
    scn = Scenario(design=DesignPoint(*TABLE2), apps=tuple(APPS),
                   scheduler="etf", governor=governor)
    sr = sweep(scn, axes, device="cpu")
    out = dict(avg_latency_us=sr.avg_latency_us, makespan_us=sr.makespan_us,
               energy_j=sr.energy_j, peak_temp_c=sr.peak_temp_c,
               busy_per_pe_us=sr.busy_per_pe_us)
    per_lane, moved = [], 0
    for (s, f, t), _ in np.ndenumerate(np.empty((2, len(sets), 2))):
        at = (s, f, t, 0) if params else (s, f, t)
        got = {k: np.asarray(v[at], np.float64) for k, v in out.items()}
        want = simulate_lane(Design(*TABLE2), APPS, traces[t].arrival_us,
                             traces[t].app_index, ["etf", "met"][s],
                             governor, params, faults=sets[f])
        per_lane.append(check.gaps(got, want))
        base = (s, 0, t, 0) if params else (s, 0, t)
        moved += bool(sr.avg_latency_us[at] != sr.avg_latency_us[base])
    worst = check.widest(per_lane)
    assert worst["makespan"] == 0.0
    for k in ("latency", "energy", "busy"):
        assert worst[k] < 1e-6, (k, worst)
    assert worst["temp"] < 1e-2
    assert moved >= len(sets)           # the faults change most lanes


@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_a_fault_fired_twice_or_past_the_makespan_changes_nothing(governor):
    (trace,) = _traces(SEED % 997, 1, 60, 20.0)
    params = ONDEMAND if governor == "ondemand" else None

    def run(faults):
        return simulate_lane(Design(*TABLE2), APPS, trace.arrival_us,
                             trace.app_index, "etf", governor, params,
                             faults=faults)

    free = run(())
    once = run(((10, 1000.0),))
    assert _hex(once) != _hex(free)
    assert _hex(run(((10, 1000.0), (10, 1000.0)))) == _hex(once)
    assert run(((10, 1000.0), (10, 1000.0))).records == once.records
    late = run(((0, free.makespan_us + 1.0), (14, 2 * free.makespan_us)))
    assert _hex(late) == _hex(free) and late.records == free.records


def test_the_table_scheduler_refuses_faults():
    """The reference raises; the harness lets the program's refusal
    (``BackendCapabilityError``) surface instead of working round it."""
    from repro_torch.scenario import BackendCapabilityError
    (trace,) = _traces(3, 1, 20, 20.0)
    with pytest.raises(ValueError):
        simulate_lane(Design(*TABLE2), APPS, trace.arrival_us,
                      trace.app_index, "table", "performance",
                      faults=((0, 100.0),))
    config = {"apps": APPS, "designs": {"table2": [list(TABLE2)]},
              "governors": {"table2": "performance"},
              "fault_sets": {"one": [[], [[0, 100.0]]]}}
    traffic = {"entry": "sweep", "designs": "table2", "fault_sets": "one",
               "axes": [["scheduler", ["table"]], ["faults", "faults"],
                        ["trace", "traces"]]}
    entry = entries.make(config, traffic, "cpu")
    entry.build()
    with pytest.raises(BackendCapabilityError):
        entry.call(entries.job_traces([trace], APPS))


def _fault_entry(sets):
    config = {"apps": APPS, "designs": {"table2": [list(TABLE2)]},
              "governors": {"table2": "performance"},
              "fault_sets": {"s": sets}}
    traffic = {"entry": "sweep", "designs": "table2", "fault_sets": "s",
               "axes": [["scheduler", ["etf", "met"]], ["faults", "faults"],
                        ["trace", "traces"]]}
    return entries.make(config, traffic, "cpu")


def test_fault_lanes_and_launches():
    """Each lane carries its set; K1's fault bytes count only where a set
    fires, over the fault axis's lanes; sets none of which fires describe
    the fault-free launch over the other axes."""
    traces = _traces(5, 3, 10, 20.0)
    entry = _fault_entry([[], [[0, 500.0]], [[14, 500.0], [3, 900.0]]])
    lanes = entry.lanes(traces)
    assert entry.shape(traces) == (2, 3, 3) and len(lanes) == 18
    assert [l.faults for l in lanes[:9:3]] == [
        (), ((0, 500.0),), ((14, 500.0), (3, 900.0))]
    (a, b) = entry.launches(traces)
    assert a == b and a.faults and a.L == 9 and a.P == 15
    noop = _fault_entry([[], [[2, math.inf]]]).launches(traces)
    free = entries.make(
        {"apps": APPS, "designs": {"table2": [list(TABLE2)]},
         "governors": {"table2": "performance"}},
        {"entry": "sweep", "designs": "table2",
         "axes": [["scheduler", ["etf", "met"]], ["trace", "traces"]]},
        "cpu").launches(traces)
    assert noop == free and not noop[0].faults and noop[0].L == 3
    assert a.bytes - entries.Launch(**dict(
        vars(a), faults=False)).bytes == 4 * (9 * 15 + 9 * 10 * 8 + 2 * 9)


@pytest.mark.parametrize("cell", sorted(ds3bench_tiny.FAULTS))
def test_the_tiny_fault_cells_are_data_alone_and_lose_work(tmp_path, cell):
    """The fault cells' files are a configuration with ``fault_sets``, a
    traffic mix and a limits file; every fault set moves some lane."""
    root = ds3bench_tiny.make_root(tmp_path)
    c = spec.load_cell(root, cell)
    assert c.config["fault_sets"]["pe_loss"] == ds3bench_tiny.FAULT_SETS
    assert ["faults", "faults"] in c.traffic["axes"]
    prep = runner.prepare(root, cell, SEED, "cpu")
    _, outs, _ = runner.timed_calls(prep, 0.0, "cpu")
    lat = outs[0][1]["avg_latency_us"]
    f_axis = [n for n, _ in c.traffic["axes"]].index("faults")
    lat = np.moveaxis(lat, f_axis, 0).reshape(len(ds3bench_tiny.FAULT_SETS),
                                               -1)
    for k in range(1, len(lat)):
        assert (lat[k] != lat[0]).any(), k
