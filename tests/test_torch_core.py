"""The port's JAX-free DS3 core against the JAX package's: the event-heap
oracle, the tables, governors, thermal model, schedulers and design space.
Inputs are made with numpy from a seed (through the job generators) and given
to both packages; every field must be equal."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dvfs as jdvfs
from repro.core import thermal as jthermal
from repro.core.applications import get_application as jget_app
from repro.core.jobgen import poisson_trace as jpoisson
from repro.core.resources import make_soc_table2 as jsoc
from repro.core.schedulers import TableScheduler as JTable
from repro.core.schedulers import get_scheduler as jget_sched
from repro.core.schedulers import solve_optimal_table as jsolve
from repro.core.simkernel_jax import build_tables as jbuild
from repro.core.simkernel_ref import simulate as jsimulate
from repro.dse import space as jspace
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import thermal as tthermal
from repro_torch.core.applications import get_application as tget_app
from repro_torch.core.jobgen import poisson_trace as tpoisson
from repro_torch.core.resources import make_soc_table2 as tsoc
from repro_torch.core.schedulers import TableScheduler as TTable
from repro_torch.core.schedulers import get_scheduler as tget_sched
from repro_torch.core.schedulers import solve_optimal_table as tsolve
from repro_torch.core.simkernel_ref import simulate as tsimulate
from repro_torch.core.simkernel_torch import ARRAY_FIELDS
from repro_torch.core.simkernel_torch import build_tables as tbuild
from repro_torch.dse import space as tspace
from repro_torch.scenario import FaultSpec

torch.set_num_threads(1)

APPS5 = ["wifi_tx", "wifi_rx", "single_carrier", "range_detection",
         "pulse_doppler"]


def _sched(mod_get, mod_table, mod_solve, db, apps, policy):
    if policy != "table":
        return mod_get(policy)
    table = {}
    for app in apps:
        table.update(mod_solve(db, app))
    return mod_table(table)


def _both(policy, governor=None, failures=None, rate=15.0, jobs=40, seed=3):
    """The same five-app simulation through both packages' reference kernels."""
    jdb, tdb = jsoc(with_viterbi=True), tsoc(with_viterbi=True)
    japps = [jget_app(n) for n in APPS5]
    tapps = [tget_app(n) for n in APPS5]
    jtr = jpoisson(rate, jobs, APPS5, seed=seed)
    ttr = tpoisson(rate, jobs, APPS5, seed=seed)
    jgov = jdvfs.get_governor(governor) if governor else None
    tgov = tdvfs.get_governor(governor) if governor else None
    jres = jsimulate(jdb, japps, jtr, _sched(jget_sched, JTable, jsolve, jdb,
                                             japps, policy), jgov,
                     failures=failures)
    tres = tsimulate(tdb, tapps, ttr, _sched(tget_sched, TTable, tsolve, tdb,
                                             tapps, policy), tgov,
                     failures=failures)
    return jres, tres


def _assert_simresult_equal(jres, tres):
    assert [dataclasses.astuple(r) for r in tres.records] \
        == [dataclasses.astuple(r) for r in jres.records]
    np.testing.assert_array_equal(tres.job_arrival_us, jres.job_arrival_us)
    np.testing.assert_array_equal(tres.job_finish_us, jres.job_finish_us)
    assert tres.makespan_us == jres.makespan_us
    for f in dataclasses.fields(jres.energy):
        np.testing.assert_array_equal(np.asarray(getattr(tres.energy, f.name)),
                                      np.asarray(getattr(jres.energy, f.name)))
    assert tres.avg_job_latency_us == jres.avg_job_latency_us


@pytest.mark.parametrize("policy", ["met", "etf", "table"])
def test_ref_kernel_equals_the_reference_on_five_apps(policy):
    _assert_simresult_equal(*_both(policy))


@pytest.mark.parametrize("governor", ["ondemand", "throttle", "powersave"])
def test_ref_kernel_equals_the_reference_under_governors(governor):
    _assert_simresult_equal(*_both("etf", governor=governor, rate=40.0))


@pytest.mark.parametrize("policy", ["met", "etf"])
def test_ref_kernel_equals_the_reference_with_a_fault(policy):
    jres, tres = _both(policy, failures=[FaultSpec(pe_id=0, fail_time_us=300.0),
                                         (9, 500.0)])
    _assert_simresult_equal(jres, tres)
    assert not any(r.pe_id == 0 and r.finish_us > 300.0 for r in tres.records)


def test_ref_kernel_refuses_a_telemetry_recorder():
    """The recorder is duck-typed, as in the reference: a static governor
    never calls it; under ondemand the port's recorder takes every window
    and the schedule is the same as without one."""
    from repro_torch.obs.telemetry import TelemetryRecorder
    db = tsoc()
    app = [tget_app("wifi_tx")]
    trace = tpoisson(10.0, 4, ["wifi_tx"], seed=0)
    tsimulate(db, app, trace, tget_sched("etf"), telemetry=object())
    gov = tdvfs.get_governor("ondemand")
    rec = TelemetryRecorder(gov.sample_window_us)
    got = tsimulate(db, app, trace, tget_sched("etf"), gov, telemetry=rec)
    want = tsimulate(db, app, trace, tget_sched("etf"),
                     tdvfs.get_governor("ondemand"))
    assert [dataclasses.astuple(r) for r in got.records] \
        == [dataclasses.astuple(r) for r in want.records]
    assert rec.build(3).num_windows > 0


def _table_cases():
    yield "performance", {}
    yield "powersave", {}
    yield "userspace", {}
    yield "ondemand", {}
    yield "ondemand", {"pad_tasks": 12, "pad_pes": 20}
    yield "performance", {"pad_tasks": 9, "pad_pes": 17, "table": True}
    yield "throttle", {"freq_caps": {"A15": 1.4, "A7": 1.0}}


@pytest.mark.parametrize("governor,kw", list(_table_cases()),
                         ids=lambda v: str(v))
def test_build_tables_equals_the_reference(governor, kw):
    kw = dict(kw)
    jdb, tdb = jsoc(with_viterbi=True), tsoc(with_viterbi=True)
    japps = [jget_app(n) for n in APPS5]
    tapps = [tget_app(n) for n in APPS5]
    if kw.pop("table", False):
        jt, tt = {}, {}
        for ja, ta in zip(japps, tapps):
            jt.update(jsolve(jdb, ja))
            tt.update(tsolve(tdb, ta))
        assert jt == tt
        kw_j, kw_t = dict(kw, table=jt), dict(kw, table=tt)
    else:
        kw_j = kw_t = kw
    jtb = jbuild(jdb, japps, governor=jdvfs.get_governor(governor), **kw_j)
    ttb = tbuild(tdb, tapps, governor=tdvfs.get_governor(governor),
                 device="cpu", **kw_t)
    assert (ttb.t_max, ttb.num_pes) == (jtb.t_max, jtb.num_pes)
    for name in ARRAY_FIELDS:
        want = getattr(jtb, name)
        got = getattr(ttb, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_governor_transitions_equal_the_reference():
    rng = np.random.default_rng(0)
    opp = np.sort(rng.uniform(0.2, 2.0, size=(3, jdvfs.MAX_OPP_LEVELS)),
                  axis=1).astype(np.float32)
    num = np.asarray([jdvfs.MAX_OPP_LEVELS, 3, 1], np.int32)
    for up in (0.5, 0.8, 0.95):
        util = rng.uniform(0.0, 1.0, size=3).astype(np.float32)
        np.testing.assert_array_equal(
            tdvfs.ondemand_index(opp, num, up, util),
            jdvfs.ondemand_index(opp, num, up, util))
    temps = np.asarray([50.0, 70.0, 90.0])
    idx = np.asarray([3, 4, 5])
    np.testing.assert_array_equal(tdvfs.throttle_index(idx, temps, 60.0),
                                  jdvfs.throttle_index(idx, temps, 60.0))
    for t in ("A15", "A7"):
        assert tdvfs.padded_ladder(t, {"A15": 1.4}) \
            == jdvfs.padded_ladder(t, {"A15": 1.4})
    gov = tdvfs.get_governor("throttle")
    jpol = jdvfs.get_governor("throttle").policy()
    assert dataclasses.asdict(gov.policy()) == dataclasses.asdict(jpol)


def test_thermal_model_equals_the_reference():
    A, B = tthermal.exact_step_matrices(0.05)
    jA, jB = jthermal.exact_step_matrices(0.05)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)
    p = np.asarray([1.5, 0.4, 0.9])
    np.testing.assert_array_equal(tthermal.steady_state(p),
                                  jthermal.steady_state(p))
    np.testing.assert_array_equal(
        tthermal.exact_step(np.full(4, 30.0), p, A, B),
        jthermal.exact_step(np.full(4, 30.0), p, jA, jB))
    lam, proj = tthermal._rc_spectral()
    jlam, jproj = jthermal._rc_spectral()
    np.testing.assert_array_equal(lam, jlam)
    np.testing.assert_array_equal(proj, jproj)


def test_design_space_equals_the_reference():
    jsp, tsp = jspace.DesignSpace(), tspace.DesignSpace()
    assert [dataclasses.astuple(p) for p in tsp.grid()] \
        == [dataclasses.astuple(p) for p in jsp.grid()]
    assert [dataclasses.astuple(p) for p in tsp.sample_lhs(8, seed=2)] \
        == [dataclasses.astuple(p) for p in jsp.sample_lhs(8, seed=2)]
    point = tspace.DesignPoint(num_vit=1)
    assert point.num_pes == 15 and point.area_mm2 == \
        jspace.DesignPoint(num_vit=1).area_mm2
