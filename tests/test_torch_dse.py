"""``repro_torch.dse`` (pareto, search, reports, the transient thermal
functions), ``repro_torch.core.reports`` and ``repro_torch.obs.metrics`` on
the CPU, against the JAX package on the same seeded inputs: the DSE cases of
tests/test_dse.py, tests/test_scenario.py, tests/test_dtpm.py and
tests/test_obs.py.

Tolerances (those of tests/test_torch_sweep.py): latency and energy 1e-6
relative, peak temperature 1e-5 (sums and the RC steps torch and XLA take in
different orders); the schedule (makespan) exact.  The port's ``evaluate``
against the port's ``sweep``: bit for bit.  The Euler transient against the
numpy integrator 1e-5 relative / 1e-4 absolute (as the reference's test),
against JAX's 1e-5.  Report text is compared as strings, exactly.  Fronts
are compared by membership on grids whose objectives hold no pair of values
closer than four times those tolerances (asserted first), so no dominance
can turn on the last bits.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dse as jdse
from repro.core import reports as jreports
from repro.core import thermal as jthermal_ref
from repro.dse import thermal_jax
from repro.scenario import FaultSpec as JFaultSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import run as jrun
import repro_torch.dse as dse
from repro_torch.core import get_application, poisson_trace, reports, thermal
from repro_torch.core.applications import wifi_tx
from repro_torch.core.dvfs import OndemandGovernor
from repro_torch.core.simkernel_torch import ARRAY_FIELDS
from repro_torch.dse import (DesignPoint, DesignSpace, EvalResult,
                             build_design_batch, crowding_distance, evaluate,
                             format_front, front_csv, non_dominated_sort,
                             pareto_mask, pareto_search, stack_traces,
                             successive_halving, thermal_torch,
                             transient_trace)
from repro_torch.obs import metrics
from repro_torch.scenario import FaultSpec, Scenario, TraceSpec, run, sweep

torch.set_num_threads(1)

APPS = ["wifi_tx", "wifi_rx"]
TOL = {"avg_latency_us": 1e-6, "energy_j": 1e-6, "peak_temp_c": 1e-5}
MIX = dict(apps=("wifi_tx", "wifi_rx"),
           trace=dict(rate_jobs_per_ms=20.0, num_jobs=16, seed=1))


def _apps(names=APPS):
    return ([get_application(n) for n in names],
            [jcore.get_application(n) for n in names])


def _traces(n=2, jobs=12, rate=25.0, seed=0, names=APPS):
    return ([poisson_trace(rate, jobs, names, seed=seed + i) for i in range(n)],
            [jcore.poisson_trace(rate, jobs, names, seed=seed + i)
             for i in range(n)])


def _jpoints(points):
    return [jdse.DesignPoint(**dataclasses.asdict(p)) for p in points]


def pair(spec, **kw):
    spec = dict(spec, **kw)
    trace = spec.pop("trace")
    return (Scenario(trace=TraceSpec(**trace), **spec),
            JScenario(trace=JTraceSpec(**trace), **spec))


def assert_eval_close(got, want):
    """An EvalResult of the port against the reference's on the same
    designs and traces."""
    assert got.points == tuple(DesignPoint(**dataclasses.asdict(p))
                               for p in want.points)
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=tol, atol=0, err_msg=name)
    for name, tol in (("latency_per_trace_us", 1e-6),
                      ("energy_per_trace_j", 1e-6),
                      ("temp_per_trace_c", 1e-5)):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=tol, atol=0, err_msg=name)


def assert_no_ties(got, want):
    """No two designs' objectives lie within four times the tolerances of
    each other unless both packages give them exactly equal: a dominance
    test cannot then turn on the last bits."""
    a, b = want.objectives(), got.objectives()
    tol = np.array([TOL[k] for k in ("avg_latency_us", "energy_j",
                                     "peak_temp_c")] + [1e-6] * (a.shape[1]
                                                                  - 3))
    close = np.abs(a[:, None] - a[None]) <= 4 * tol * np.abs(a)[:, None]
    exact = (a[:, None] == a[None]) & (b[:, None] == b[None])
    off = ~np.eye(len(a), dtype=bool)[..., None]
    assert not np.any(close & ~exact & off), "objectives tie within tolerance"


# ------------------------------------------------------------------ pareto

def test_pareto_mask_hand_checkable():
    costs = np.array([[1.0, 5.0], [2.0, 2.0], [5.0, 1.0],
                      [2.0, 5.0], [3.0, 3.0], [6.0, 6.0]])
    assert pareto_mask(costs).tolist() == [True, True, True,
                                           False, False, False]
    assert pareto_mask(costs).tolist() == jdse.pareto_mask(costs).tolist()


def test_pareto_duplicates_both_survive():
    costs = np.array([[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]])
    assert pareto_mask(costs).tolist() == [True, True, False]


def test_non_dominated_sort_ranks():
    costs = np.array([[1.0, 4.0], [4.0, 1.0], [2.0, 5.0], [5.0, 2.0],
                      [6.0, 6.0]])
    assert non_dominated_sort(costs).tolist() == [0, 0, 1, 1, 2]
    rng = np.random.default_rng(0)
    costs = rng.uniform(size=(40, 3))
    np.testing.assert_array_equal(non_dominated_sort(costs),
                                  jdse.non_dominated_sort(costs))
    np.testing.assert_array_equal(dse.pareto_order(costs),
                                  jdse.pareto_order(costs))


def test_crowding_distance_boundaries_inf():
    costs = np.array([[0.0, 4.0], [1.0, 2.0], [2.0, 1.0], [4.0, 0.0]])
    d = crowding_distance(costs)
    assert np.isinf(d[0]) and np.isinf(d[3])
    assert np.all(np.isfinite(d[1:3])) and np.all(d[1:3] > 0)
    np.testing.assert_array_equal(d, jdse.crowding_distance(costs))


# ------------------------------------------------------------------ thermal

def test_transient_matches_numpy_reference():
    trace = np.random.default_rng(0).uniform(0.0, 3.0, size=(50, 3))
    ref = jthermal_ref.simulate_trace(trace, dt_s=0.02)
    got = transient_trace(trace, 0.02, device="cpu").numpy()
    assert got.shape == (50, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(thermal_jax.transient_trace(trace, 0.02)), rtol=1e-5)
    # from a given start, and one step of it, as the reference's
    init = np.array([40.0, 35.0, 30.0, 28.0])
    np.testing.assert_allclose(
        transient_trace(trace[:5], 0.02, init=init, device="cpu").numpy(),
        np.asarray(thermal_jax.transient_trace(trace[:5], 0.02, init=init)),
        rtol=1e-5)
    step = thermal_torch.euler_step(torch.tensor(init, dtype=torch.float32),
                                    torch.tensor(trace[0], dtype=torch.float32),
                                    0.02)
    np.testing.assert_allclose(
        step.numpy(), np.asarray(thermal_jax.euler_step(
            np.float32(init), np.float32(trace[0]), np.float32(0.02))),
        rtol=1e-6)
    np.testing.assert_array_equal(
        thermal_torch.rc_state_matrix(device="cpu").numpy(),
        np.asarray(thermal_jax.rc_state_matrix()))


def test_thermal_scan_converges_to_steady_state():
    power = np.array([3.0, 1.0, 0.5])
    expect = thermal.steady_state(power)
    trace = np.tile(power, (30000, 1))                # 30000 * 0.05s = 1500 s
    temps = transient_trace(trace, 0.05, device="cpu").numpy()
    np.testing.assert_allclose(temps[-1], expect, rtol=1e-3)
    np.testing.assert_allclose(
        thermal_torch.steady_state(torch.tensor(power, dtype=torch.float32))
        .numpy(), expect, rtol=1e-5)


# ------------------------------------------------------------------- search

def test_evaluate_shapes_and_front():
    pts = DesignSpace().sample_lhs(8, seed=1)
    (apps, japps), (traces, jtraces) = _apps(), _traces(2)
    res = evaluate(pts, apps, traces, device="cpu")
    assert res.objectives().shape == (8, 3)
    assert res.latency_per_trace_us.shape == (8, 2)
    mask = res.front_mask()
    assert mask.any() and mask.shape == (8,)
    want = jdse.evaluate(_jpoints(pts), japps, jtraces)
    assert_eval_close(res, want)
    assert_no_ties(res, want)
    np.testing.assert_array_equal(mask, want.front_mask())


def test_successive_halving_prunes():
    pts = DesignSpace().sample_lhs(12, seed=2)
    (apps, japps), (traces, jtraces) = _apps(), _traces(3)
    res = successive_halving(pts, apps, traces, eta=2, min_survivors=4,
                             device="cpu")
    assert res.num_designs == 6                       # 12 // eta
    assert set(res.points) <= set(pts)
    cheap = evaluate(pts, apps, traces[:1], device="cpu")
    assert_no_ties(cheap, jdse.evaluate(_jpoints(pts), japps, jtraces[:1]))
    assert_eval_close(res, jdse.successive_halving(_jpoints(pts), japps,
                                                   jtraces, eta=2,
                                                   min_survivors=4))


def test_pareto_search_deterministic_and_grows():
    kw = dict(rounds=2, batch_size=8, seed=5)
    tr = [poisson_trace(20.0, 8, ["wifi_tx"], seed=0)]
    a = pareto_search(DesignSpace(), [wifi_tx()], tr, device="cpu", **kw)
    b = pareto_search(DesignSpace(), [wifi_tx()], tr, device="cpu", **kw)
    assert a.archive.points == b.archive.points
    np.testing.assert_array_equal(a.archive.objectives(),
                                  b.archive.objectives())
    assert a.archive.num_designs > 8                  # refinement added points
    assert a.front.sum() >= 1
    assert len(a.rounds) == 2
    assert [r["evaluated"] for r in a.rounds] == [
        8, a.archive.num_designs - 8]
    want = jdse.pareto_search(jdse.DesignSpace(), [jcore.wifi_tx()],
                              [jcore.poisson_trace(20.0, 8, ["wifi_tx"],
                                                   seed=0)], **kw)
    # the second round's candidates come from the first round's front
    assert_no_ties(a.archive, want.archive)
    assert_eval_close(a.archive, want.archive)
    np.testing.assert_array_equal(a.front, want.front)


def test_search_timer_and_counter_are_obs_metrics():
    evaluated = metrics.counter("dse.search.designs_evaluated")
    n0 = evaluated.value
    sr = pareto_search(DesignSpace(), [wifi_tx()],
                       [poisson_trace(20.0, 8, ["wifi_tx"], seed=0)],
                       rounds=1, batch_size=4, seed=0, device="cpu")
    assert evaluated.value - n0 == sr.archive.num_designs == 4
    t = metrics.timer("dse.pareto_search.round")
    assert t.count >= 1 and sr.rounds[0]["wall_s"] == t.last_s


def test_front_members_equal_jax_on_a_tie_free_lhs_grid():
    pts = DesignSpace().sample_lhs(24, seed=3)
    (apps, japps), (traces, jtraces) = _apps(), _traces(2, jobs=16, seed=4)
    got = evaluate(pts, apps, traces, device="cpu")
    want = jdse.evaluate(_jpoints(pts), japps, jtraces)
    assert_no_ties(got, want)
    front = {p for p, m in zip(got.points, got.front_mask()) if m}
    jfront = {DesignPoint(**dataclasses.asdict(p))
              for p, m in zip(want.points, want.front_mask()) if m}
    assert front == jfront and len(front) >= 2


def test_energy_mj_aliases_removed():
    tscn, jscn = pair(MIX)
    ev = evaluate([DesignPoint(2, 2, 1, 1, 0)], tscn.applications(),
                  [tscn.job_trace()], device="cpu")
    assert not hasattr(ev, "energy_mj")
    assert np.all(ev.energy_j > 0)
    want = jdse.evaluate([jdse.DesignPoint(2, 2, 1, 1, 0)],
                         jscn.applications(), [jscn.job_trace()])
    np.testing.assert_allclose(ev.energy_j, want.energy_j, rtol=1e-6)


def test_dse_evaluate_equals_sweep():
    points = [DesignPoint(4, 4, 2, 4, 0), DesignPoint(1, 2, 0, 1, 0)]
    tscn, jscn = pair(MIX)
    traces = [tscn.with_seed(s).job_trace() for s in (0, 1, 2)]
    ev = evaluate(points, tscn.applications(), traces, policy="etf",
                  device="cpu")
    sr = sweep(tscn.replace(governor="design"),
               axes={"design": points, "seed": [0, 1, 2]}, device="cpu")
    np.testing.assert_array_equal(ev.latency_per_trace_us, sr.avg_latency_us)
    np.testing.assert_array_equal(ev.energy_per_trace_j, sr.energy_j)
    np.testing.assert_array_equal(ev.temp_per_trace_c, sr.peak_temp_c)
    want = jdse.evaluate(_jpoints(points), jscn.applications(),
                         [jscn.with_seed(s).job_trace() for s in (0, 1, 2)])
    assert_eval_close(ev, want)


def test_dynamic_governor_respects_design_freq_caps():
    """dse.evaluate's capped batch under ondemand equals run() of the point,
    and JAX's evaluate."""
    point = DesignPoint(4, 4, 2, 4, 0, big_freq_ghz=1.0)
    tscn, jscn = pair(dict(apps=("wifi_tx",),
                           trace=dict(rate_jobs_per_ms=60.0, num_jobs=120,
                                      seed=3)),
                      design=point, governor="ondemand")
    res = run(tscn, device="cpu")
    ev = evaluate([point], [wifi_tx()], [tscn.job_trace()],
                  governor="ondemand", device="cpu")
    # evaluate adds the 50 ms RC step; the schedule does not read it
    assert ev.latency_per_trace_us[0, 0] == res.avg_latency_us
    want = jdse.evaluate([jdse.DesignPoint(**dataclasses.asdict(point))],
                         [jcore.wifi_tx()], [jscn.job_trace()],
                         governor="ondemand")
    assert_eval_close(ev, want)


def test_dse_evaluate_ranks_dynamic_policies():
    points = [DesignPoint(4, 4, 2, 4, 0), DesignPoint(1, 2, 0, 1, 0)]
    traces, jtraces = _traces(2, jobs=16, rate=20.0, names=["wifi_tx"])
    ev = evaluate(points, [wifi_tx()], traces, governor="ondemand",
                  governor_params=(("thermal_dt_s", 0.05),), device="cpu")
    assert ev.avg_latency_us.shape == (2,)
    assert np.all(np.isfinite(ev.objectives()))
    assert np.all(ev.peak_temp_c >= 25.0 - 1e-6)
    assert_eval_close(ev, jdse.evaluate(
        _jpoints(points), [jcore.wifi_tx()], jtraces, governor="ondemand",
        governor_params=(("thermal_dt_s", 0.05),)))
    with pytest.raises(ValueError, match="design"):
        evaluate(points, [wifi_tx()], traces, governor="performance",
                 device="cpu")
    # a batch built for the other governor kind, and a mismatched batch
    static = build_design_batch(points, [wifi_tx()], device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        evaluate(points, [wifi_tx()], traces, governor="ondemand",
                 batch=static, device="cpu")
    with pytest.raises(ValueError, match="batch.points"):
        evaluate(points[:1], [wifi_tx()], traces, batch=static, device="cpu")


@pytest.mark.parametrize("governor", ["design", "ondemand"])
def test_evaluate_faults_degraded_objectives_match_jax(governor):
    points = [DesignPoint(2, 2, 1, 2, 0), DesignPoint(4, 4, 2, 4, 0)]
    sets = [(), ((0, 200.0),), ((1, 100.0), (2, 300.0))]
    faults = [tuple(FaultSpec(*f) for f in fs) for fs in sets]
    jfaults = [tuple(JFaultSpec(*f) for f in fs) for fs in sets]
    traces, jtraces = _traces(2, jobs=12, rate=25.0, names=["wifi_tx"])
    ev = evaluate(points, [wifi_tx()], traces, governor=governor,
                  faults=faults, device="cpu")
    want = jdse.evaluate(_jpoints(points), [jcore.wifi_tx()], jtraces,
                         governor=governor, faults=jfaults)
    assert ev.objectives().shape == (2, 4)
    assert_eval_close(ev, want)
    for name in ("degraded_latency_us", "degraded_energy_j",
                 "latency_per_fault_us"):
        np.testing.assert_allclose(getattr(ev, name), getattr(want, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert ev.latency_per_fault_us.shape == (3, 2)
    assert np.all(ev.degraded_latency_us >= ev.avg_latency_us)
    # the nominal objectives are the no-op lane's: evaluate without faults
    nominal = evaluate(points, [wifi_tx()], traces, governor=governor,
                       device="cpu")
    np.testing.assert_array_equal(ev.latency_per_trace_us,
                                  nominal.latency_per_trace_us)


# ------------------------------------------------------------------ reports

def _eval_pair(obj):
    """The same objectives as an EvalResult of each package."""
    pts = DesignSpace().sample_lhs(len(obj), seed=9)
    kw = dict(avg_latency_us=obj[:, 0], energy_j=obj[:, 1],
              peak_temp_c=obj[:, 2], latency_per_trace_us=obj[:, :1],
              energy_per_trace_j=obj[:, 1:2], temp_per_trace_c=obj[:, 2:])
    return (EvalResult(points=tuple(pts), **kw),
            jdse.EvalResult(points=tuple(_jpoints(pts)), **kw))


def test_format_front_and_csv_equal_the_reference_text():
    obj = np.random.default_rng(2).uniform([40, 1e-3, 26], [120, 5e-3, 32],
                                           size=(16, 3))
    got, want = _eval_pair(obj)
    assert format_front(got) == jdse.format_front(want)
    assert front_csv(got) == jdse.front_csv(want)
    assert format_front(got).startswith(
        f"Pareto front: {int(pareto_mask(obj).sum())} of 16 designs")


def test_reports_main_runs_on_the_cpu(capsys):
    res = dse.reports.main(["--designs", "6", "--traces", "2", "--jobs", "8",
                            "--device", "cpu", "--csv"])
    out = capsys.readouterr().out
    assert res.num_designs == 6
    assert out.startswith("Pareto front: ") and "(incl. kernel build)" in out
    assert out.count("design,area_mm2,") == 1
    sr = dse.reports.main(["--designs", "4", "--traces", "1", "--jobs", "8",
                           "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("round 0: evaluated    4") and sr.num_designs > 4


def test_core_reports_equal_the_reference_text():
    tscn, jscn = pair(MIX)
    got, want = run(tscn, backend="ref"), jrun(jscn, backend="ref")
    db, jdb = tscn.soc(), jscn.soc()
    assert reports.schedule_table(db, got.raw, max_rows=10) \
        == jreports.schedule_table(jdb, want.raw, max_rows=10)
    assert reports.gantt_ascii(db, got.raw, width=60) \
        == jreports.gantt_ascii(jdb, want.raw, width=60)
    rows = [reports.summarize(db, got.raw, "etf", 20.0)]
    assert rows == [jreports.summarize(jdb, want.raw, "etf", 20.0)]
    assert reports.summary_csv(rows) == jreports.summary_csv(rows)


# ------------------------------------------------------------ obs, shims

def test_counter_and_timer_registry():
    c = metrics.counter("test_obs.count")
    assert metrics.counter("test_obs.count") is c      # registry identity
    c.reset()
    assert c.inc() == 1 and c.inc(3) == 4
    assert c.value == 4 and int(c) == 4
    t = metrics.timer("test_obs.timer")
    with t:
        pass
    assert t.count >= 1 and t.last_s >= 0.0
    assert t.last_us == t.last_s * 1e6
    snap = metrics.snapshot()
    assert snap["counters"]["test_obs.count"] == 4
    assert "test_obs.timer" in snap["timers"]
    tscn, jscn = pair(MIX)
    assert metrics.scenario_hash(tscn) == metrics.scenario_hash(tscn)
    assert len(metrics.scenario_hash(tscn)) == 12


def test_dse_simulate_design_batch_shim_warns_and_matches():
    points = [DesignPoint(2, 2, 1, 1, 0)]
    tscn, _ = pair(MIX)
    batch = build_design_batch(points, tscn.applications(), device="cpu")
    arrival, app_idx = stack_traces([tscn.job_trace()], device="cpu")
    with pytest.warns(DeprecationWarning, match="repro_torch.scenario"):
        out = dse.simulate_design_batch(batch, "etf", arrival, app_idx)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        direct = dse.batch.simulate_design_batch(batch, "etf", arrival,
                                                 app_idx)
    assert torch.equal(out["makespan_us"], direct["makespan_us"])
    sr = sweep(tscn.replace(governor="design"),
               axes={"design": points, "seed": [tscn.trace.seed]},
               device="cpu")
    assert out["avg_job_latency_us"][0, 0].item() == sr.avg_latency_us[0, 0]


# ---------------------------------------------- the tables layer, whole grid

APPS5 = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
         "pulse_doppler")
GRID_CASES = ("grid-static", "lhs-ondemand")


def _grid_points(case):
    """The benchmark's design sets: every design of the hull under its own
    caps, and the DTPM cells' 64 LHS designs under ondemand."""
    if case == "grid-static":
        return DesignSpace().grid(), None
    return DesignSpace().sample_lhs(64, seed=0), OndemandGovernor


@functools.lru_cache(maxsize=None)
def _grid_batches(case):
    """The port's and the reference's ``build_design_batch`` of a set."""
    (tapps, japps), (points, gov) = _apps(APPS5), _grid_points(case)
    return (build_design_batch(points, tapps, device="cpu",
                               governor=gov and gov()),
            jdse.build_design_batch(
                _jpoints(points), japps,
                governor=gov and getattr(jcore.dvfs, gov.__name__)()))


@pytest.mark.parametrize("field", ARRAY_FIELDS + ("batch.node_of_pe",))
@pytest.mark.parametrize("case", GRID_CASES)
def test_design_batch_tables_equal_the_reference_bit_for_bit(case, field):
    got, want = _grid_batches(case)
    name = field.split(".")[-1]
    got, want = ((b if field.startswith("batch.") else b.tables)
                 for b in (got, want))
    got, want = getattr(got, name), getattr(want, name)
    if want is None:
        assert got is None
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), field


@pytest.mark.parametrize("case", GRID_CASES)
def test_tables_counters_count_designs_and_kinds(case):
    for name in (metrics.DESIGNS_BUILT, metrics.PE_KINDS):
        metrics.counter(name).reset()
    points, gov = _grid_points(case)
    batch = build_design_batch(points, _apps(APPS5)[0], device="cpu",
                               governor=gov and gov())
    man = metrics.run_manifest(device="cpu")
    assert man[metrics.DESIGNS_BUILT] == batch.num_designs \
        == (1080 if case == "grid-static" else 64)
    # A15 and A7 at two clocks (caps) each, three accelerators
    assert man[metrics.PE_KINDS] == 7
