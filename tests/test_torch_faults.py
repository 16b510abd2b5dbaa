"""Fail-stop faults in the port's epoch scan (K1's plain version on the CPU)
against the JAX package: the kernel and facade cases of
tests/test_faults_jax.py, fed identical tables through ``tables_from_numpy``.

Tolerances: ``scheduled``, ``start``, ``finish``, ``onpe`` and the makespan
equal ``simulate_jax(faults=)`` bit for bit, with communication or without;
under DTPM so do ``onopp`` and ``opp_idx`` against
``simulate_jax_dtpm(faults=)``.  Energy and ``peak_temp_c`` are held at 1e-5
relative (sums that XLA and torch take in different orders; the port's
window sums are exact fixed-point sums).  On comm-free traces the schedule
also equals the port's event-heap oracle bit for bit.  ``run(backend=
"torch", device="cpu")`` is held to ``repro.scenario.run(backend="jax")``
at 1e-4 on latency and makespan and 1e-3 on energy (the reference's own
ref/jax tolerances), and its schedule arrays bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import (deterministic_trace, get_scheduler, make_soc_table2,
                        poisson_trace, wifi_tx)
from repro.core.dvfs import OndemandGovernor as JOndemand
from repro.core.resources import CommModel
from repro.core.simkernel_jax import build_tables, simulate_jax, \
    simulate_jax_dtpm
from repro.scenario import FaultSpec as JFaultSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import pe_loss_faults as j_pe_loss_faults
from repro.scenario import run as jrun
from repro.scenario.faults import fault_plan as j_fault_plan
from repro.scenario.faults import fault_scan_steps as j_fault_scan_steps
from repro.scenario.faults import stack_fault_plans as j_stack_fault_plans
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import simkernel_ref as tref
from repro_torch.core import simkernel_torch as skt
from repro_torch.core.applications import wifi_tx as t_wifi_tx
from repro_torch.core.jobgen import deterministic_trace as t_det_trace
from repro_torch.core.resources import CommModel as TCommModel
from repro_torch.core.resources import make_soc_table2 as t_soc
from repro_torch.core.schedulers import get_scheduler as t_get_scheduler
from repro_torch.kernels import epoch_scan as k1
from repro_torch.scenario import (BackendCapabilityError, FaultSpec,
                                  Scenario, TraceSpec, pe_loss_faults, run)
from repro_torch.scenario.faults import (fault_plan, fault_scan_steps,
                                         stack_fault_plans)

torch.set_num_threads(1)

SCHEDULE = ("scheduled", "start", "finish", "onpe", "makespan_us")
DTPM_SCHEDULE = SCHEDULE + ("onopp", "opp_idx")
SCN = dict(apps=("wifi_tx",),
           trace=dict(rate_jobs_per_ms=25.0, num_jobs=24, seed=3))
POLICY_FIELDS = ("dynamic", "up_threshold", "sample_window_us",
                 "thermal_cap_c", "thermal_dt_s")
GOVERNORS = {"ondemand": {},
             "throttle": dict(thermal_cap_c=27.0, thermal_dt_s=0.05)}
# fault sets of tests/test_faults_jax.py as (pe_id, fail_time_us)
CASES = {"single": ((0, 500.0),),
         "t0": ((1, 0.0),),
         "two": ((0, 300.0), (1, 800.0)),
         "simultaneous": ((0, 400.0), (2, 400.0)),
         "staggered": ((0, 312.5), (1, 937.5))}


def port_tables(tb):
    """The JAX package's tables, carried across as numpy."""
    return skt.tables_from_numpy(jax.tree_util.tree_map(np.asarray, tb),
                                 tb.t_max, tb.num_pes, "cpu")


def port_policy(pol):
    return tdvfs.GovernorPolicy(**{k: getattr(pol, k) for k in POLICY_FIELDS})


def dbs(comm: bool = False):
    """The Table-2 SoC in both packages, comm-free unless ``comm``."""
    db, tdb = make_soc_table2(), t_soc()
    if not comm:
        db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
        tdb.comm = TCommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    return db, tdb


def accelerators(db):
    return [j for j, pe in enumerate(db.pes) if not pe.is_cpu]


def plan_of(db, faults):
    return j_fault_plan(tuple(JFaultSpec(*f) for f in faults), db.num_pes)


def assert_schedule_equal(got, want, keys=SCHEDULE):
    for key in keys:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def run_static(db, trace, policy, faults):
    """simulate_jax(faults=) and the port's plain faulted scan on the same
    tables; the schedule bit for bit, energy at 1e-5."""
    tb = build_tables(db, [wifi_tx()])
    plan = plan_of(db, faults)
    want = simulate_jax(tb, policy, trace.arrival_us, trace.app_index,
                        faults=plan)
    got = skt.simulate_torch(port_tables(tb), policy, trace.arrival_us,
                             trace.app_index, faults=plan)
    assert set(got) == set(want) | {"steps", "commits"}
    assert_schedule_equal(got, want)
    np.testing.assert_allclose(float(got["energy_j"]), float(want["energy_j"]),
                               rtol=1e-5)
    J, T = np.asarray(want["finish"]).shape
    assert int(got["commits"]) <= int(got["steps"]) \
        <= fault_scan_steps(J, T, len(faults))
    return got


def assert_equals_oracle(tdb, trace_args, policy, faults, got, governor=None):
    """The comm-free schedule equals the port's event-heap oracle."""
    ref = tref.simulate(tdb, [t_wifi_tx()], t_det_trace(*trace_args),
                        t_get_scheduler(policy), governor,
                        failures=[FaultSpec(*f) for f in faults])
    fin, start, onpe = (got[k].numpy() for k in ("finish", "start", "onpe"))
    assert ref.records
    for r in ref.records:
        assert fin[r.job_id, r.task_id] == np.float32(r.finish_us)
        assert start[r.job_id, r.task_id] == np.float32(r.start_us)
        assert onpe[r.job_id, r.task_id] == r.pe_id
    assert int(got["scheduled"].sum()) == len(ref.records)
    assert float(got["makespan_us"]) == np.float32(ref.makespan_us)
    return ref


# ------------------------------------------------- kernel-level bit-for-bit

def scaled(case, scale):
    return tuple((pe, t * scale) for pe, t in CASES[case])


@pytest.mark.parametrize("policy", ["etf", "met"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("period", [25.0, 5.0], ids=["light", "loaded"])
def test_faulted_scan_equals_simulate_jax_and_the_oracle(period, case,
                                                         policy):
    """The reference's trace (a job every 25 us), and one every 5 us, where
    queues are long and the faults roll back many tasks (fail times scaled
    with the period)."""
    db, tdb = dbs()
    trace = deterministic_trace(period, 48, ["wifi_tx"])
    faults = scaled(case, period / 25.0)
    got = run_static(db, trace, policy, faults)
    assert_equals_oracle(tdb, (period, 48, ["wifi_tx"]), policy, faults, got)


@pytest.mark.parametrize("policy", ["etf", "met"])
@pytest.mark.parametrize("case", list(CASES))
def test_faulted_scan_equals_simulate_jax_with_comm(case, policy):
    db, _ = dbs(comm=True)
    run_static(db, poisson_trace(200.0, 40, ["wifi_tx"], seed=3), policy,
               scaled(case, 0.2))


def test_the_cases_roll_back_and_skip():
    """The loaded cases do reach the rollback (re-commits) and the stale
    pick (a step that commits nothing)."""
    db, _ = dbs()
    tb = port_tables(build_tables(db, [wifi_tx()]))
    trace = deterministic_trace(5.0, 48, ["wifi_tx"])
    recommits = skips = 0
    for case in CASES:
        for policy in ("etf", "met"):
            got = skt.simulate_torch(tb, policy, trace.arrival_us,
                                     trace.app_index,
                                     faults=plan_of(db, scaled(case, 0.2)))
            recommits += int(got["commits"]) - int(got["scheduled"].sum())
            skips += int(got["steps"]) - int(got["commits"])
    assert recommits > 20 and skips >= 1


def test_multi_fault_poisson_bitforbit():
    db, _ = dbs()
    run_static(db, poisson_trace(20.0, 64, ["wifi_tx"], seed=3), "met",
               ((0, 300.0), (4, 700.0)))


@pytest.mark.parametrize("policy", ["etf", "met"])
def test_accelerator_wipeout_degrades_gracefully(policy):
    """All accelerators dead: their tasks fall back to CPU PEs; the run
    completes, equal to the reference, with a strictly worse makespan."""
    db, tdb = dbs()
    accel = accelerators(db)
    assert accel
    trace = deterministic_trace(5.0, 48, ["wifi_tx"])
    wipe = tuple((p, 125.0) for p in accel)
    got = run_static(db, trace, policy, wipe)
    ref = assert_equals_oracle(tdb, (5.0, 48, ["wifi_tx"]), policy, wipe, got)
    free = tref.simulate(tdb, [t_wifi_tx()], t_det_trace(5.0, 48, ["wifi_tx"]),
                         t_get_scheduler(policy))
    assert ref.makespan_us > free.makespan_us
    done = got["scheduled"].numpy()
    onpe, fin = got["onpe"].numpy()[done], got["finish"].numpy()[done]
    # nothing finishes on a dead accelerator after its fail time
    assert not np.any(np.isin(onpe, accel) & (fin > 125.0))
    # the rollback re-committed tasks: more commits than valid tasks
    assert int(got["commits"]) > int(done.sum())


@pytest.mark.parametrize("policy", ["etf", "met"])
def test_every_pe_dead_takes_pe_0_as_the_reference(policy):
    """Once every PE is dead each candidate is inf: argmin's first index,
    PE 0, as jnp.argmin (K1 must not keep its 'no PE yet' sentinel)."""
    db, _ = dbs()
    trace = deterministic_trace(25.0, 24, ["wifi_tx"])
    every = tuple((p, 300.0 + 10.0 * p) for p in range(db.num_pes))
    got = run_static(db, trace, policy, every)
    late = got["start"].numpy() >= 300.0 + 10.0 * db.num_pes
    assert late.any() and (got["onpe"].numpy()[late] == 0).all()


@pytest.mark.parametrize("governor", list(GOVERNORS))
@pytest.mark.parametrize("policy", ["etf", "met"])
def test_dtpm_faults_equal_simulate_jax_dtpm(policy, governor):
    db, tdb = dbs()
    gov = JOndemand(sample_window_us=50.0, **GOVERNORS[governor])
    trace = deterministic_trace(10.0, 32, ["wifi_tx"])
    faults = ((0, 120.0), (4, 200.0))
    tb = build_tables(db, [wifi_tx()], governor=gov)
    want = simulate_jax_dtpm(tb, policy, trace.arrival_us, trace.app_index,
                             gov.policy(), faults=plan_of(db, faults))
    got = skt.simulate_torch_dtpm(port_tables(tb), policy, trace.arrival_us,
                                  trace.app_index, port_policy(gov.policy()),
                                  faults=plan_of(db, faults))
    assert_schedule_equal(got, want, DTPM_SCHEDULE)
    for key in ("energy_j", "peak_temp_c"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    tgov = tdvfs.OndemandGovernor(sample_window_us=50.0, **GOVERNORS[governor])
    assert_equals_oracle(tdb, (10.0, 32, ["wifi_tx"]), policy, faults, got,
                         tgov)


@pytest.mark.parametrize("governor", list(GOVERNORS))
def test_dtpm_faults_with_comm_and_a_wipeout(governor):
    """Communication and every accelerator lost mid-trace under DTPM: the
    rollback re-opens jobs the window walk had passed (the carry repairs)."""
    db, _ = dbs(comm=True)
    gov = JOndemand(**GOVERNORS[governor])
    trace = poisson_trace(60.0, 64, ["wifi_tx"], seed=0)
    faults = tuple((p, float(np.float32(trace.arrival_us[30])))
                   for p in accelerators(db))
    tb = build_tables(db, [wifi_tx()], governor=gov)
    want = simulate_jax_dtpm(tb, "etf", trace.arrival_us, trace.app_index,
                             gov.policy(), faults=plan_of(db, faults))
    got = skt.simulate_torch_dtpm(port_tables(tb), "etf", trace.arrival_us,
                                  trace.app_index, port_policy(gov.policy()),
                                  faults=plan_of(db, faults))
    assert_schedule_equal(got, want, DTPM_SCHEDULE)
    for key in ("energy_j", "peak_temp_c"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(got["commits"]) > int(got["scheduled"].sum())


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dtpm"])
def test_batch_of_per_lane_plans_equals_each_lane_alone(dynamic):
    db, _ = dbs(comm=True)
    gov = JOndemand() if dynamic else None
    tb = port_tables(build_tables(db, [wifi_tx()], governor=gov))
    traces = [poisson_trace(r, 40, ["wifi_tx"], seed=s)
              for r, s in ((10.0, 0), (30.0, 1), (60.0, 2), (30.0, 1))]
    sets = [(), ((0, 300.0),), ((1, 0.0), (5, 900.0)),
            tuple((p, 400.0) for p in accelerators(db))]
    plans, n = stack_fault_plans([[FaultSpec(*f) for f in fs] for fs in sets],
                                 db.num_pes)
    arrival = np.stack([t.arrival_us for t in traces])
    app_idx = np.stack([t.app_index for t in traces])
    if dynamic:
        pol = port_policy(gov.policy())
        batch = skt.simulate_batch_dtpm(tb, "etf", arrival, app_idx, pol,
                                        faults=plans)
    else:
        batch = skt.simulate_batch(tb, "etf", arrival, app_idx, faults=plans)
    keys = DTPM_SCHEDULE + ("peak_temp_c",) if dynamic else SCHEDULE
    for k, (trace, fs) in enumerate(zip(traces, sets)):
        plan = fault_plan([FaultSpec(*f) for f in fs], db.num_pes)
        if dynamic:
            one = skt.simulate_torch_dtpm(tb, "etf", trace.arrival_us,
                                          trace.app_index, pol, faults=plan)
        else:
            one = skt.simulate_torch(tb, "etf", trace.arrival_us,
                                     trace.app_index, faults=plan)
        for key in keys + ("energy_j", "steps", "commits"):
            if key in one:
                assert torch.equal(batch[key][k], one[key]), (k, key)
    # the fault-free lane of the batch equals the fault-free program
    free = skt.simulate_batch(tb, "etf", arrival[:1], app_idx[:1]) \
        if not dynamic else skt.simulate_batch_dtpm(tb, "etf", arrival[:1],
                                                    app_idx[:1], pol)
    for key in keys:
        assert torch.equal(batch[key][:1], free[key]), key
    J, T = arrival.shape[1], tb.t_max
    assert int(batch["steps"].max()) <= fault_scan_steps(J, T, n)


def test_faults_refused_where_the_reference_refuses():
    db, _ = dbs()
    tb = port_tables(build_tables(db, [wifi_tx()]))
    trace = deterministic_trace(25.0, 8, ["wifi_tx"])
    plan = plan_of(db, CASES["single"])
    with pytest.raises(ValueError, match="table"):
        skt.simulate_torch(tb, "table", trace.arrival_us, trace.app_index,
                           faults=plan)
    with pytest.raises(ValueError, match="faults"):
        skt.simulate_torch(tb, "etf", trace.arrival_us, trace.app_index,
                           faults=plan[:-1])
    with pytest.raises(ValueError, match="NaN"):
        k1.epoch_scan_plain(tb, "etf", torch.zeros(1, 8), torch.zeros(
            1, 8, dtype=torch.int32), faults=torch.full((1, db.num_pes),
                                                        float("nan")))


# ------------------------------------------------------------ facade: run()

def pair(spec, faults=(), **kw):
    spec = dict(spec, **kw)
    trace = spec.pop("trace")
    return (Scenario(trace=TraceSpec(**trace),
                     failures=tuple(FaultSpec(*f) for f in faults), **spec),
            JScenario(trace=JTraceSpec(**trace),
                      failures=tuple(JFaultSpec(*f) for f in faults), **spec))


@pytest.mark.parametrize("governor", ["performance", "ondemand", "throttle"])
@pytest.mark.parametrize("policy", ["etf", "met"])
def test_run_faults_torch_equals_jax(policy, governor):
    tscn, jscn = pair(SCN, ((0, 500.0), (9, 200.0)), scheduler=policy,
                      governor=governor)
    got = run(tscn, backend="torch", device="cpu")
    want = jrun(jscn, backend="jax")
    for name, tol in (("avg_latency_us", 1e-4), ("makespan_us", 1e-4),
                      ("energy_j", 1e-3)):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=tol, err_msg=name)
    keys = SCHEDULE + (("onopp", "opp_idx") if governor != "performance"
                       else ())
    assert_schedule_equal(got.raw, want.raw, keys)


def test_noop_faults_take_the_fault_free_program():
    """Empty and all-inf fault specs run the fault-free program."""
    tscn, _ = pair(SCN)
    free = run(tscn, device="cpu")
    for failures in ((), (FaultSpec(0, float("inf")),)):
        res = run(tscn.replace(failures=failures), device="cpu")
        assert res.makespan_us == free.makespan_us
        assert res.energy_j == free.energy_j
        assert "steps" not in res.raw
    assert fault_plan((), 14) is None
    assert fault_plan((FaultSpec(3, float("inf")),), 14) is None
    plans, max_f = stack_fault_plans([(), (FaultSpec(0, np.inf),)], 14)
    assert plans is None and max_f == 0


def test_run_refuses_table_with_faults_and_telemetry():
    tscn, _ = pair(SCN, ((0, 500.0),), scheduler="table")
    with pytest.raises(BackendCapabilityError, match="'table' scheduler"):
        run(tscn, device="cpu")
    with pytest.raises(BackendCapabilityError, match="item 9"):
        run(tscn.replace(scheduler="etf", governor="ondemand",
                         telemetry=True), device="cpu")


# ------------------------------------------------------ plans and bounds

def test_stack_fault_plans_and_scan_steps_equal_their_twins():
    sets = [(), ((0, 500.0),), ((0, 300.0), (1, 800.0)),
            ((3, float("inf")),), ((2, 1e-9), (2, 50.0))]
    got, n = stack_fault_plans([[FaultSpec(*f) for f in fs] for fs in sets],
                               14, width=16)
    want, jn = j_stack_fault_plans([[JFaultSpec(*f) for f in fs]
                                    for fs in sets], 14, width=16)
    assert n == jn == 2
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32
    for J, T, F in ((10, 6, 0), (10, 6, 2), (1000, 8, 1)):
        assert fault_scan_steps(J, T, F) == j_fault_scan_steps(J, T, F)
    assert fault_scan_steps(10, 6, 2) == 60 * 3 + 2


def test_pe_loss_faults_enumerates_subsets():
    lanes = pe_loss_faults(range(4), fail_time_us=10.0, k=2)
    assert len(lanes) == 6                      # C(4, 2)
    assert all(len(fs) == 2 for fs in lanes)
    assert all(f.fail_time_us == 10.0 for fs in lanes for f in fs)
    want = j_pe_loss_faults(range(4), fail_time_us=10.0, k=2)
    assert [[(f.pe_id, f.fail_time_us) for f in fs] for fs in lanes] == \
        [[(f.pe_id, f.fail_time_us) for f in fs] for fs in want]
