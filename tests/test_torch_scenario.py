"""``repro_torch.scenario.run`` against ``repro.scenario.run``: the static
cases of tests/test_scenario.py on the CPU, the dynamic governors, the ref
backend, the RC thermal pipeline, and what the port's ``"torch"`` backend
refuses for now.

Tolerances: Result floats 1e-6 relative (latency, energy and utilization are
sums XLA and torch take in different orders; makespan is exact), peak
temperature 1e-5 (the binned trace's sum and the RC steps run in another
order than XLA's fused program); the schedule arrays are bit-for-bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.dse import thermal_jax as jthermal
from repro.dse import DesignPoint as JDesignPoint
from repro.scenario import FaultSpec as JFaultSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import ThermalSpec as JThermalSpec
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import run as jrun
from repro_torch.dse import DesignPoint
from repro_torch.dse import thermal_torch as tthermal
from repro_torch.scenario import (BackendCapabilityError, FaultSpec, Result,
                                  Scenario, ScenarioError, ThermalSpec,
                                  TraceSpec, run, tables_for)

torch.set_num_threads(1)

SCN = dict(apps=("wifi_tx",),
           trace=dict(rate_jobs_per_ms=25.0, num_jobs=24, seed=3))
MIX = dict(apps=("wifi_tx", "wifi_rx"),
           trace=dict(rate_jobs_per_ms=20.0, num_jobs=16, seed=1))
EXACT = ("scheduled", "start", "finish", "onpe", "job_finish", "makespan_us")


def pair(spec, faults=(), **kw):
    """The same scenario in both packages; ``faults`` as (pe_id, time)."""
    spec = dict(spec, **kw)
    trace = spec.pop("trace")
    return (Scenario(trace=TraceSpec(**trace),
                     failures=tuple(FaultSpec(*f) for f in faults), **spec),
            JScenario(trace=JTraceSpec(**trace),
                      failures=tuple(JFaultSpec(*f) for f in faults), **spec))


def assert_results_match(got, want):
    assert got.backend == "torch" and want.backend == "jax"
    assert got.makespan_us == want.makespan_us
    for name in ("avg_latency_us", "throughput_jobs_per_ms", "energy_j",
                 "avg_power_w"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_allclose(got.utilization, want.utilization, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(got.peak_temp_c, want.peak_temp_c, rtol=1e-5)
    for key in EXACT:
        np.testing.assert_array_equal(got.raw[key].numpy(),
                                      np.asarray(want.raw[key]), err_msg=key)


@pytest.mark.parametrize("governor", ["performance", "powersave", "design"])
@pytest.mark.parametrize("policy", ["met", "etf", "table"])
def test_run_torch_equals_run_jax(governor, policy):
    tscn, jscn = pair(MIX, scheduler=policy, governor=governor)
    assert_results_match(run(tscn, backend="torch", device="cpu"),
                         jrun(jscn, backend="jax"))


@pytest.mark.parametrize("design", [(1, 2, 0, 1, 0), (0, 4, 1, 2, 1, 1.4)],
                         ids=["b1L2f1", "L4s1f2v1"])
def test_run_torch_equals_run_jax_on_other_designs(design):
    tscn, jscn = pair(SCN, governor="design")
    tscn = tscn.replace(design=DesignPoint(*design))
    jscn = jscn.replace(design=JDesignPoint(*design))
    assert_results_match(run(tscn, backend="torch", device="cpu"),
                         jrun(jscn, backend="jax"))


def test_run_torch_thermal_settings_and_trace_override():
    tscn, jscn = pair(SCN)
    tscn = tscn.replace(thermal=ThermalSpec(bins=16, repeats=2))
    jscn = jscn.replace(thermal=JThermalSpec(bins=16, repeats=2))
    assert_results_match(run(tscn, backend="torch", device="cpu"),
                         jrun(jscn, backend="jax"))
    other = tscn.with_seed(11).job_trace()
    got = run(tscn, device="cpu", trace_override=other)
    want = jrun(jscn, backend="jax",
                trace_override=jscn.with_seed(11).job_trace())
    assert_results_match(got, want)


@pytest.mark.parametrize("spec", [SCN, MIX], ids=["wifi_tx", "mix"])
def test_run_ref_equals_the_reference(spec):
    tscn, jscn = pair(spec, faults=[(0, 100.0)])
    got, want = run(tscn, backend="ref"), jrun(jscn, backend="ref")
    assert got.backend == "ref"
    for name in ("avg_latency_us", "throughput_jobs_per_ms", "makespan_us",
                 "energy_j", "avg_power_w", "peak_temp_c"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.utilization, want.utilization)
    assert got.manifest is None


def test_run_ref_supports_ondemand():
    tscn, jscn = pair(SCN, governor="ondemand")
    assert run(tscn, backend="ref").avg_latency_us \
        == jrun(jscn, backend="ref").avg_latency_us


def test_result_metrics_surface_on_the_cpu():
    tscn, _ = pair(SCN)
    for backend in ("ref", "torch"):
        res = run(tscn, backend=backend, device="cpu")
        assert isinstance(res, Result)
        assert res.utilization.shape == (tscn.design.num_pes,)
        assert res.throughput_jobs_per_ms > 0
        assert res.peak_temp_c >= 25.0 - 1e-6
        assert res.energy_j > 0 and res.avg_power_w > 0


def test_default_scenario_runs_on_the_cpu_and_tables_are_cached():
    res = run(Scenario(), backend="torch", device="cpu")
    assert res.makespan_us > 0
    a = tables_for(Scenario(), device="cpu")
    assert tables_for(Scenario(scheduler="met").with_seed(5),
                      device="cpu") is a
    assert tables_for(Scenario(scheduler="table"), device="cpu") is not a
    assert hash(Scenario()) == hash(Scenario().replace())


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
def test_run_torch_runs_dynamic_governors(governor):
    """The closed DTPM loop on the "torch" backend: the same Result as the
    JAX package's, peak temperature from the inline RC loop (the window sums
    and the RC matrices round in another order: energy and power 1e-5)."""
    tscn, jscn = pair(SCN, governor=governor)
    got = run(tscn, backend="torch", device="cpu")
    want = jrun(jscn, backend="jax")
    assert got.backend == "torch" and want.backend == "jax"
    assert got.makespan_us == want.makespan_us
    for name, tol in (("avg_latency_us", 1e-6),
                      ("throughput_jobs_per_ms", 1e-6), ("energy_j", 1e-5),
                      ("avg_power_w", 1e-5), ("peak_temp_c", 1e-5)):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=tol, atol=0, err_msg=name)
    np.testing.assert_allclose(got.utilization, want.utilization, rtol=1e-6,
                               atol=1e-12)
    for key in EXACT + ("onopp", "opp_idx"):
        np.testing.assert_array_equal(got.raw[key].numpy(),
                                      np.asarray(want.raw[key]), err_msg=key)


@pytest.mark.parametrize("change,match", [
    # faults run (tests/test_torch_faults.py); not with the table scheduler
    (dict(failures=(FaultSpec(0, 100.0),), scheduler="table"),
     "'table' scheduler"),
    (dict(telemetry=True), "item 9"),
])
def test_run_torch_raises_for_what_is_not_ported(change, match):
    scn = Scenario().replace(**change)
    with pytest.raises(BackendCapabilityError, match=match):
        run(scn, backend="torch", device="cpu")


def test_run_torch_takes_a_noop_fault_spec_and_rejects_unknown_backends():
    scn = Scenario(failures=(FaultSpec(0, float("inf")),))
    base = run(Scenario(), backend="torch", device="cpu")
    assert run(scn, backend="torch", device="cpu").avg_latency_us \
        == base.avg_latency_us
    with pytest.raises(ScenarioError, match="backend"):
        run(Scenario(), backend="jax", device="cpu")
    with pytest.raises(BackendCapabilityError, match="item 9"):
        run(Scenario(), backend="ref", telemetry=True)


def test_binned_power_trace_and_peak_temperature_equal_thermal_jax():
    rng = np.random.default_rng(0)
    J, T, P = 12, 5, 9
    start = rng.uniform(0, 400, (J, T)).astype(np.float32)
    finish = (start + rng.uniform(1, 60, (J, T))).astype(np.float32)
    onpe = rng.integers(0, P, (J, T)).astype(np.int32)
    valid = rng.uniform(size=(J, T)) < 0.8
    nodes = rng.integers(0, 3, P).astype(np.int32)
    p_act = rng.uniform(0.1, 3.0, P).astype(np.float32)
    p_idle = rng.uniform(0.01, 0.2, P).astype(np.float32)
    makespan = np.float32(finish[valid].max())
    want_trace, want_dt = jthermal.binned_power_trace(
        start, finish, onpe, valid, nodes, p_act, p_idle, makespan, bins=24)
    t = torch.from_numpy
    got_trace, got_dt = tthermal.binned_power_trace(
        t(start), t(finish), t(onpe), t(valid), t(nodes), t(p_act), t(p_idle),
        torch.tensor(makespan), bins=24)
    np.testing.assert_allclose(got_trace.numpy(), np.asarray(want_trace),
                               rtol=1e-6, atol=1e-7)
    assert float(got_dt) == float(want_dt)
    want_peak = jthermal.peak_temperature(want_trace, want_dt, repeats=3)
    got_peak = tthermal.peak_temperature(got_trace, got_dt, repeats=3)
    np.testing.assert_allclose(float(got_peak), float(want_peak), rtol=1e-5)
    p = rng.uniform(0, 2, 3).astype(np.float32)
    np.testing.assert_allclose(tthermal.steady_state(t(p)).numpy(),
                               np.asarray(jthermal.steady_state(p)), rtol=1e-7)
    jA, jB = jax.jit(jthermal.exact_step_matrices)(np.float32(2e-4))
    A, B = tthermal.exact_step_matrices(torch.tensor(2e-4))
    # entries that cancel to ~1e-9 of B's largest: held relative to the largest
    for got, want in ((A, jA), (B, jB)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
