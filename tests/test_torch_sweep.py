"""``repro_torch.scenario.sweep`` on the CPU (K1's plain version) against
``repro.scenario.sweep(backend="jax")`` and the port's own ``run``: the sweep
cases of tests/test_scenario.py, tests/test_dtpm.py and
tests/test_faults_jax.py, then the layer below them — the plain scan on
stacked tables of padded designs against each design alone, the lane
permutation, the thermal grid and the policy stack.

Tolerances (those of tests/test_torch_scenario.py): makespan and the
schedule arrays exact; latency, throughput, energy and per-PE busy time
1e-6 relative (sums torch and XLA take in different orders); peak
temperature 1e-5.  Against the port's ``run`` the same.  A lane of a stacked
scan against its design alone: every output bit for bit.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.core.dvfs import GovernorPolicy as JPolicy
from repro.core.dvfs import OndemandGovernor as JOndemand
from repro.core.dvfs import stack_policies as j_stack_policies
from repro.dse import DesignPoint as JDesignPoint
from repro.dse import build_design_batch as j_build_design_batch
from repro.dse import thermal_jax as jthermal
from repro.scenario import FaultSpec as JFaultSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import sweep as jsweep
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import simkernel_torch as skt
from repro_torch.core.applications import wifi_tx
from repro_torch.dse import (DesignBatch, DesignPoint, build_design_batch,
                             peak_temperature_grid, stack_tables,
                             stack_traces)
from repro_torch.dse import batch as tbatch
# the kernel entry directly: the package's re-export is a deprecation shim
from repro_torch.dse.batch import simulate_design_batch
from repro_torch.dse import thermal_torch as tthermal
from repro_torch.kernels import epoch_scan as k1
from repro_torch.scenario import (BackendCapabilityError, FaultSpec,
                                  LaneAxisError, Scenario, ScenarioError,
                                  SweepResult, TraceSpec, run, sweep,
                                  tables_for)
from repro_torch.scenario.faults import stack_fault_plans

# the module (the package's `sweep` attribute is the function)
sweep_mod = importlib.import_module("repro_torch.scenario.sweep")

torch.set_num_threads(1)

SCN = dict(apps=("wifi_tx",),
           trace=dict(rate_jobs_per_ms=25.0, num_jobs=24, seed=3))
MIX = dict(apps=("wifi_tx", "wifi_rx"),
           trace=dict(rate_jobs_per_ms=20.0, num_jobs=16, seed=1))
# 8, 13 and 19 PEs; the first has no big core (a lower peak power)
WIDTHS = [(0, 4, 1, 2, 1), (2, 4, 2, 4, 1), (4, 8, 2, 4, 1)]
THROTTLE = (("thermal_cap_c", 27.0), ("thermal_dt_s", 0.05))
FAULT_LANES = [(), ((0, 500.0),), ((0, 300.0), (1, 800.0))]
RATES = [5.0, 20.0]
SCHEDULE = ("scheduled", "start", "finish", "onpe")


def pair(spec, **kw):
    """The same base scenario in both packages."""
    spec = dict(spec, **kw)
    trace = spec.pop("trace")
    return (Scenario(trace=TraceSpec(**trace), **spec),
            JScenario(trace=JTraceSpec(**trace), **spec))


def designs(points):
    return ([DesignPoint(*p) for p in points],
            [JDesignPoint(*p) for p in points])


def faults(sets):
    return ([tuple(FaultSpec(*f) for f in fs) for fs in sets],
            [tuple(JFaultSpec(*f) for f in fs) for fs in sets])


def scans():
    return sum(sweep_mod.scan_calls.values())


def assert_sweeps_match(got: SweepResult, want: SweepResult):
    assert got.backend == "torch" and got.shape == want.shape
    np.testing.assert_array_equal(got.makespan_us, want.makespan_us)
    for name in ("avg_latency_us", "throughput_jobs_per_ms", "energy_j"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_allclose(got.busy_per_pe_us, want.busy_per_pe_us,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.peak_temp_c, want.peak_temp_c, rtol=1e-5)


def assert_lane_is_run(sr: SweepResult, idx, res):
    assert sr.makespan_us[idx] == res.makespan_us
    for name in ("avg_latency_us", "throughput_jobs_per_ms", "energy_j"):
        np.testing.assert_allclose(getattr(sr, name)[idx], getattr(res, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    P = res.utilization.shape[0]
    np.testing.assert_allclose(sr.utilization[idx][:P], res.utilization,
                               rtol=1e-6, atol=1e-12)
    assert np.all(sr.busy_per_pe_us[idx][P:] == 0)
    np.testing.assert_allclose(sr.peak_temp_c[idx], res.peak_temp_c,
                               rtol=1e-5)


# ------------------------------------------------ tests/test_scenario.py

def test_sweep_two_axes_matches_run_and_jax_in_one_scan():
    pts, jpts = designs([(4, 4, 2, 4, 0), (1, 2, 0, 1, 0),
                         (0, 4, 1, 2, 1, 1.4)])
    tscn, jscn = pair(MIX)
    n0 = dict(sweep_mod.scan_calls)
    sr = sweep(tscn, axes={"rate": [5.0, 40.0], "design": pts}, device="cpu")
    assert sweep_mod.scan_calls == {**n0, (False, False): n0[False, False] + 1}
    assert sr.shape == (2, 3) and sr.avg_latency_us.shape == (2, 3)
    assert sr.busy_per_pe_us.shape == (2, 3, 14)
    assert_sweeps_match(sr, jsweep(jscn, axes={"rate": [5.0, 40.0],
                                               "design": jpts}))
    for i, rate in enumerate([5.0, 40.0]):
        for d, p in enumerate(pts):
            assert_lane_is_run(sr, (i, d), run(tscn.at_rate(rate).replace(
                design=p), device="cpu"))


def test_sweep_repeat_call_starts_one_scan_each():
    tscn, _ = pair(MIX)
    axes = {"rate": [5.0, 40.0], "seed": [0, 1]}
    first = sweep(tscn, axes=axes, device="cpu")
    n0 = scans()
    again = sweep(tscn, axes=axes, device="cpu")
    assert scans() == n0 + 1                    # lanes add no scan
    np.testing.assert_array_equal(first.avg_latency_us, again.avg_latency_us)


def test_sweep_scheduler_axis_is_static():
    tscn, jscn = pair(SCN)
    axes = {"scheduler": ["met", "etf", "table"], "rate": [5.0, 40.0]}
    n0 = scans()
    sr = sweep(tscn, axes=axes, device="cpu")
    assert sr.shape == (3, 2)
    assert scans() == n0 + 3                    # one scan per scheduler
    assert_sweeps_match(sr, jsweep(jscn, axes=axes))
    for i, policy in enumerate(axes["scheduler"]):
        assert_lane_is_run(sr, (i, 1), run(tscn.replace(scheduler=policy)
                                           .at_rate(40.0), device="cpu"))


def test_sweep_design_times_governor_axes():
    pts, jpts = designs([(4, 4, 2, 4, 0), (1, 2, 0, 1, 0)])
    tscn, jscn = pair(MIX)
    govs = ["performance", "powersave"]
    sr = sweep(tscn, axes={"design": pts, "governor": govs}, device="cpu")
    assert sr.shape == (2, 2)
    assert_sweeps_match(sr, jsweep(jscn, axes={"design": jpts,
                                               "governor": govs}))
    for d, p in enumerate(pts):
        for g, gov in enumerate(govs):
            assert_lane_is_run(sr, (d, g), run(tscn.replace(
                design=p, governor=gov), device="cpu"))


def test_sweep_design_batch_validation_and_simulate_design_batch():
    (p,), _ = designs([(2, 2, 1, 1, 0)])
    tmix, _ = pair(MIX)
    tscn, _ = pair(SCN)
    batch = build_design_batch([p], tmix.applications(), device="cpu")
    assert isinstance(batch, DesignBatch) and batch.num_designs == 1
    with pytest.raises(ValueError, match="governor='design'"):
        sweep(tmix, axes={"design": [p], "seed": [0]}, design_batch=batch,
              device="cpu")
    with pytest.raises(ValueError, match="application list"):
        sweep(tscn.replace(governor="design"),
              axes={"design": [p], "seed": [0]}, design_batch=batch,
              device="cpu")
    # the batch path and simulate_design_batch equal the plain sweep
    base = tmix.replace(governor="design")
    sr = sweep(base, axes={"design": [p], "seed": [1, 2]}, device="cpu")
    via = sweep(base, axes={"design": [p], "seed": [1, 2]},
                design_batch=batch, device="cpu")
    np.testing.assert_array_equal(sr.avg_latency_us, via.avg_latency_us)
    arrival, app_idx = stack_traces([base.with_seed(s).job_trace()
                                     for s in (1, 2)], device="cpu")
    out = simulate_design_batch(batch, "etf", arrival, app_idx)
    assert out["avg_job_latency_us"].shape == (1, 2)
    np.testing.assert_array_equal(out["makespan_us"].double().numpy(),
                                  sr.makespan_us)


def test_sweep_frequency_cap_axis():
    tscn, jscn = pair(MIX, governor="design")
    axes = {"design.big_freq_ghz": [1.4, 2.0], "seed": [0, 1]}
    sr = sweep(tscn, axes=axes, device="cpu")
    assert sr.shape == (2, 2)
    assert np.all(sr.avg_latency_us[0] >= sr.avg_latency_us[1] - 1e-6)
    assert_sweeps_match(sr, jsweep(jscn, axes=axes))


def test_sweep_ref_backend_matches_run_and_the_reference():
    tscn, jscn = pair(SCN)
    axes = {"rate": [5.0, 40.0], "seed": [0, 1]}
    sr = sweep(tscn, axes=axes, backend="ref")
    assert sr.backend == "ref"
    ref = run(tscn.at_rate(40.0).with_seed(1), backend="ref")
    assert sr.avg_latency_us[1, 1] == ref.avg_latency_us
    assert sr.peak_temp_c[1, 1] == ref.peak_temp_c
    want = jsweep(jscn, axes=axes, backend="ref")
    for name in ("avg_latency_us", "makespan_us", "energy_j", "peak_temp_c",
                 "busy_per_pe_us"):
        np.testing.assert_array_equal(getattr(sr, name), getattr(want, name))


def test_sweep_explicit_trace_axis_matches_spec_axis():
    tscn, _ = pair(SCN)
    specs = [dataclasses.replace(tscn.trace, seed=s) for s in (0, 1)]
    traces = [s.materialize(tscn.app_names()) for s in specs]
    a = sweep(tscn, axes={"trace": specs}, device="cpu")
    b = sweep(tscn, axes={"trace": traces}, device="cpu")
    np.testing.assert_array_equal(a.avg_latency_us, b.avg_latency_us)


def test_sweep_validates_axes():
    tscn, _ = pair(SCN)
    with pytest.raises(LaneAxisError, match="unknown sweep axis"):
        sweep(tscn, axes={"voltage": [1.0]}, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        sweep(tscn, axes={}, device="cpu")
    with pytest.raises(ValueError, match="equal job counts"):
        sweep(tscn, axes={"jobs": [8, 16]}, device="cpu")
    assert sweep(tscn, axes={"jobs": [8, 16]}, backend="ref").shape == (2,)
    with pytest.raises(ValueError, match="duplicate sweep axes"):
        sweep(tscn, axes={"seed": [0, 1], "trace.seed": [2, 3]}, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        sweep(tscn, axes={"seed": [0, 1], "trace": [tscn.trace]},
              device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        sweep(tscn, axes={"design": [tscn.design],
                          "design.big_freq_ghz": [1.4, 2.0]}, device="cpu")


def test_sweep_iter_records():
    tscn, _ = pair(SCN)
    sr = sweep(tscn, axes={"rate": [5.0, 40.0], "seed": [0]}, device="cpu")
    recs = list(sr.iter_records())
    assert len(recs) == 2 and sr.num_points == 2
    coords, metrics = recs[1]
    assert coords == {"rate": 40.0, "seed": 0}
    assert metrics["avg_latency_us"] == sr.avg_latency_us[1, 0]


# --------------------------------------------------- tests/test_dtpm.py

def test_sweep_32_policies_in_one_scan_with_inline_peak_temp():
    params = [(("up_threshold", u), ("sample_window_us", w))
              for u in (0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0)
              for w in (25.0, 50.0, 100.0, 200.0)]
    tscn, jscn = pair(SCN, governor="ondemand")
    n0 = dict(sweep_mod.scan_calls)
    sr = sweep(tscn, axes={"governor_params": params}, device="cpu")
    assert sweep_mod.scan_calls == {**n0, (True, False): n0[True, False] + 1}
    assert sr.shape == (32,) and np.all(sr.peak_temp_c >= 25.0 - 1e-6)
    want = jsweep(jscn, axes={"governor_params": params})
    assert_sweeps_match(sr, want)
    for k in (0, 13, 31):
        assert_lane_is_run(sr, k, run(tscn.replace(governor_params=params[k]),
                                      device="cpu"))


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
def test_sweep_policy_times_design_times_trace(governor):
    pts, jpts = designs([(4, 4, 2, 4, 0), (1, 2, 0, 1, 0)])
    extra = THROTTLE if governor == "throttle" else ()
    params = [(("up_threshold", 0.6),) + extra,
              (("up_threshold", 0.9),) + extra]
    tscn, jscn = pair(SCN, governor=governor)
    sr = sweep(tscn, axes={"design": pts, "governor_params": params,
                           "seed": [0, 1]}, device="cpu")
    assert sr.shape == (2, 2, 2)
    assert_sweeps_match(sr, jsweep(jscn, axes={
        "design": jpts, "governor_params": params, "seed": [0, 1]}))
    for d, p in enumerate(pts):
        assert_lane_is_run(sr, (d, 1, 1), run(tscn.replace(
            design=p, governor_params=params[1]).with_seed(1), device="cpu"))


def test_sweep_mixed_governor_kinds_rejected():
    tscn, _ = pair(SCN)
    with pytest.raises(LaneAxisError, match="policy shapes"):
        sweep(tscn, axes={"governor": ["performance", "ondemand"]},
              device="cpu")


def test_sweep_ref_backend_governor_params():
    params = [(("up_threshold", 0.6),), (("up_threshold", 0.9),)]
    tscn, _ = pair(SCN, governor="ondemand")
    sr = sweep(tscn, axes={"governor_params": params}, backend="ref")
    single = run(tscn.replace(governor_params=params[1]), backend="ref")
    assert sr.avg_latency_us[1] == single.avg_latency_us


def test_design_batch_gains_opp_dimension_as_the_reference():
    pts, jpts = designs([(4, 4, 2, 4, 0), (2, 2, 1, 2, 0, 1.4)])
    tscn, jscn = pair(SCN)
    static = build_design_batch(pts, tscn.applications(), device="cpu")
    assert not static.dynamic and static.tables.exec_opp is None
    dyn = build_design_batch(pts, tscn.applications(),
                             governor=tdvfs.OndemandGovernor(), device="cpu")
    want = j_build_design_batch(jpts, jscn.applications(),
                                governor=JOndemand())
    assert dyn.dynamic and dyn.tables.exec_opp.shape[0] == 2
    for name in skt.ARRAY_FIELDS:
        np.testing.assert_array_equal(
            getattr(dyn.tables, name).numpy(),
            np.asarray(getattr(want.tables, name)), err_msg=name)
    np.testing.assert_array_equal(dyn.node_of_pe.numpy(),
                                  np.asarray(want.node_of_pe))


def test_sweep_rejects_mismatched_design_batch_kind():
    (p,), _ = designs([(2, 2, 1, 1, 0)])
    tscn, _ = pair(SCN)
    apps = tscn.applications()
    dyn = build_design_batch([p], apps, governor=tdvfs.OndemandGovernor(),
                             device="cpu")
    with pytest.raises(ValueError, match="dynamic governor"):
        sweep(tscn.replace(governor="design"),
              axes={"design": [p], "seed": [0]}, design_batch=dyn,
              device="cpu")
    static = build_design_batch([p], apps, device="cpu")
    with pytest.raises(ValueError, match="OPP ladders"):
        sweep(tscn.replace(governor="ondemand"),
              axes={"design": [p], "seed": [0]}, design_batch=static,
              device="cpu")


# --------------------------------------------- tests/test_faults_jax.py

@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_fault_lane_sweep_matches_run_and_jax(governor):
    fs, jfs = faults(FAULT_LANES)
    tscn, jscn = pair(SCN, governor=governor)
    key = (governor == "ondemand", True)
    n0 = dict(sweep_mod.scan_calls)
    sr = sweep(tscn, axes={"faults": fs, "rate": RATES}, device="cpu")
    assert sweep_mod.scan_calls == {**n0, key: n0[key] + 1}   # fault lanes: 0
    assert sr.makespan_us.shape == (len(FAULT_LANES), len(RATES))
    assert_sweeps_match(sr, jsweep(jscn, axes={"faults": jfs, "rate": RATES}))
    for i, f in enumerate(fs):
        for j, rate in enumerate(RATES):
            assert_lane_is_run(sr, (i, j), run(tscn.at_rate(rate).replace(
                failures=f), device="cpu"))


def test_all_noop_fault_axis_takes_the_fault_free_program():
    tscn, _ = pair(SCN)
    n0 = dict(sweep_mod.scan_calls)
    sr = sweep(tscn, axes={"faults": [(), (FaultSpec(0, float("inf")),)],
                           "rate": RATES}, device="cpu")
    assert sweep_mod.scan_calls == {**n0, (False, False): n0[False, False] + 1}
    assert sr.makespan_us.shape == (2, len(RATES))
    np.testing.assert_array_equal(sr.makespan_us[0], sr.makespan_us[1])
    base = sweep(tscn, axes={"rate": RATES}, device="cpu")
    np.testing.assert_array_equal(sr.energy_j[1], base.energy_j)


def test_fault_sweep_composes_with_design_axis():
    tscn, jscn = pair(SCN)
    d0 = tscn.design
    d1 = dataclasses.replace(d0, num_little=d0.num_little + 2)
    jd1 = dataclasses.replace(jscn.design, num_little=d0.num_little + 2)
    fs, jfs = faults(FAULT_LANES[:2])
    sr = sweep(tscn, axes={"design": [d0, d1], "faults": fs,
                           "rate": [10.0]}, device="cpu")
    assert_sweeps_match(sr, jsweep(jscn, axes={
        "design": [jscn.design, jd1], "faults": jfs, "rate": [10.0]}))
    assert_lane_is_run(sr, (1, 1, 0), run(tscn.at_rate(10.0).replace(
        design=d1, failures=fs[1]), device="cpu"))


def test_fault_sweep_ref_backend_lane_by_lane():
    fs, _ = faults(FAULT_LANES)
    tscn, _ = pair(SCN)
    got = sweep(tscn, axes={"faults": fs, "rate": [25.0]}, device="cpu")
    ref = sweep(tscn, axes={"faults": fs, "rate": [25.0]}, backend="ref")
    np.testing.assert_allclose(got.energy_j, ref.energy_j, rtol=1e-3)


def test_typed_errors_and_what_is_not_ported():
    tscn, _ = pair(SCN)
    fs, _ = faults(FAULT_LANES[:2])
    with pytest.raises(ScenarioError, match="unknown backend"):
        sweep(tscn, axes={"rate": [5.0]}, backend="jax", device="cpu")
    with pytest.raises(BackendCapabilityError, match="chunk/shard"):
        sweep(tscn, axes={"rate": [5.0]}, backend="ref", chunk=2)
    with pytest.raises(BackendCapabilityError, match="table"):
        sweep(tscn, axes={"faults": fs, "scheduler": ["etf", "table"]},
              device="cpu")
    with pytest.raises(BackendCapabilityError,
                       match="telemetry with faults under a dynamic governor"):
        sweep(tscn.replace(governor="ondemand"), axes={"faults": fs},
              device="cpu", telemetry=True)
    # the chunked executor (item 8) is ported: chunk / shard run, and equal
    # the plain sweep (tests/test_torch_shardexec.py holds them in full)
    plain = sweep(tscn, axes={"rate": [5.0, 20.0]}, device="cpu")
    for kw in (dict(chunk=2), dict(shard=True)):
        got = sweep(tscn, axes={"rate": [5.0, 20.0]}, device="cpu", **kw)
        np.testing.assert_array_equal(got.makespan_us, plain.makespan_us)
    host = stack_tables([tables_for(tscn, device="cpu")], host=True)
    assert host.device.type == "cpu" and host.exec_us.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep(tscn, axes={"rate": [5.0]})       # the card by default


# ------------------------- four more sweeps against the reference's sweep

# each sweep: (the base scenario's overrides, its axes); `pts` / `fs` are the
# designs of 8/13/19 PEs and the fault lanes in the package at hand
FOUR_SWEEPS = {
    "table-x-designs": ({}, lambda pts, fs: {"scheduler": ["etf", "table"],
                                             "design": pts}),
    "throttle-x-faults-x-designs": (
        dict(governor="throttle", governor_params=THROTTLE),
        lambda pts, fs: {"faults": fs, "design": pts}),
    "ondemand-met-x-faults-x-designs-x-rates": (
        dict(governor="ondemand", scheduler="met"),
        lambda pts, fs: {"faults": fs[:2], "design": pts, "rate": RATES}),
    "met-x-designs-x-rates": (
        dict(scheduler="met"), lambda pts, fs: {"design": pts, "rate": RATES}),
}


@pytest.mark.parametrize("name", sorted(FOUR_SWEEPS))
def test_sweep_design_axis_matches_jax(name):
    """A design axis of 8, 13 and 19 PEs crossed with a scheduler axis that
    rebuilds the tables (`table`), fault lanes under throttle and under
    ondemand with met, and rates under met: the lanes that K1 lays out
    design-major, padded to 19 PEs, equal the reference's sweep."""
    overrides, axes = FOUR_SWEEPS[name]
    pts, jpts = designs(WIDTHS)
    fs, jfs = faults(FAULT_LANES)
    tscn, jscn = pair(SCN, **overrides)
    assert_sweeps_match(sweep(tscn, axes=axes(pts, fs), device="cpu"),
                        jsweep(jscn, axes=axes(jpts, jfs)))


# -------------------------------------------------- the layer below

def stacked(scn, points, governor="performance", params=()):
    """Each design's own (unpadded) tables and the padded stack."""
    scns = [scn.replace(design=p, governor=governor, governor_params=params)
            for p in points]
    P = max(p.num_pes for p in points)
    own = [tables_for(s, device="cpu") for s in scns]
    stack = stack_tables([tables_for(s, pad_pes=P, device="cpu")
                          for s in scns])
    return scns, own, stack


@pytest.mark.parametrize("program", ["etf", "met", "table", "throttle",
                                     "faults", "ondemand-faults"])
def test_stacked_plain_scan_equals_each_design_alone(program):
    """Three designs of 8, 13 and 19 PEs padded to 19 in one plain scan:
    every lane equals its design's own scan bit for bit.  Under DTPM the
    designs differ in peak power, and each lane's window sums must take the
    fixed-point exponents of its own design (the kernel reads the same
    ``quanta``), not of the stack's widest power."""
    pts, _ = designs(WIDTHS)
    tscn, _ = pair(MIX, **{"trace": dict(rate_jobs_per_ms=40.0, num_jobs=24,
                                         seed=2)})
    policy = program if program in ("etf", "met", "table") else "etf"
    tscn = tscn.replace(scheduler=policy)
    gov, params = {"throttle": ("throttle", THROTTLE),
                   "ondemand-faults": ("ondemand", ())}.get(
        program, ("performance", ()))
    scns, own, stack = stacked(tscn, pts, gov, params)
    traces = [tscn.with_seed(s).job_trace() for s in (2, 3)]
    arrival, app_idx = stack_traces(traces, device="cpu")
    S = len(traces)
    lanes_arr, lanes_app = arrival.repeat(3, 1), app_idx.repeat(3, 1)
    pol = None
    if gov != "performance":
        pol = tdvfs.policy_lanes(scns[0].make_policy(), 3 * S)
        # the design without a big core peaks lower than the other two
        p_max = [float(t.power_active_opp.max()) for t in own]
        assert p_max[0] < p_max[1] == p_max[2]
    plans = None
    if "faults" in program:
        plans, _ = stack_fault_plans([(FaultSpec(1, 150.0),)], 8, width=19)
        plans = torch.from_numpy(plans).expand(3 * S, 19)
    got = k1.epoch_scan_plain(stack, policy, lanes_arr, lanes_app, pol,
                              plans)
    for d, tb in enumerate(own):
        lanes = slice(d * S, (d + 1) * S)
        P = tb.num_pes
        one_plans = None if plans is None else plans[lanes, :P]
        one_pol = None if pol is None else pol.take(torch.arange(S))
        want = k1.epoch_scan_plain(tb, policy, arrival, app_idx, one_pol,
                                   one_plans)
        if pol is not None:
            # the window sums' fixed-point exponents are the design's own
            assert torch.equal(
                k1.quanta(pol.window, k1.lane_p_max(stack, 3 * S))[lanes],
                k1.quanta(one_pol.window, k1.lane_p_max(tb, S)))
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g[lanes], w), (program, d, k)


def test_throttle_design_axis_lanes_equal_their_run_on_the_schedule():
    pts, _ = designs(WIDTHS)
    tscn, _ = pair(MIX, governor="throttle", governor_params=THROTTLE)
    _, _, stack = stacked(tscn, pts, "throttle", THROTTLE)
    arrival, app_idx = stack_traces([tscn.job_trace()], device="cpu")
    gov = tdvfs.stack_policies([tscn.make_policy()])
    grid = tbatch.simulate_grid(stack, "etf", arrival, app_idx, gov=gov)
    assert grid["onopp"].shape[:3] == (3, 1, 1)
    for d, p in enumerate(pts):
        res = run(tscn.replace(design=p), device="cpu")
        for key in SCHEDULE + ("onopp", "opp_idx", "makespan_us",
                               "peak_temp_c"):
            assert torch.equal(grid[key][d, 0, 0], res.raw[key]), (d, key)


def test_design_major_permutation_round_trips():
    F, D, G, S = 2, 3, 4, 5
    x = torch.arange(F * D * G * S * 2).reshape(F, D, G, S, 2)
    lanes = tbatch.to_design_major(x)
    assert lanes.shape == (D * F * G * S, 2)
    assert torch.equal(tbatch.from_design_major(lanes, F, D, G, S), x)
    # lane l holds design l // (F*G*S), as K1 reads it
    d = torch.arange(D)[None, :, None, None].expand(F, D, G, S)
    assert torch.equal(tbatch.to_design_major(d),
                       torch.arange(D * F * G * S) // (F * G * S))
    _, _, stack = stacked(pair(SCN)[0], designs(WIDTHS)[0])
    assert torch.equal(k1.lane_designs(stack, 60), torch.arange(60) // 20)
    with pytest.raises(ValueError, match="split evenly"):
        k1.lane_designs(stack, 10)


def test_peak_temperature_grid_equals_thermal_jax():
    rng = np.random.default_rng(0)
    F, D, S, J, T, P = 2, 3, 2, 10, 5, 7
    start = rng.uniform(0, 400, (F, D, S, J, T)).astype(np.float32)
    finish = (start + rng.uniform(1, 60, start.shape)).astype(np.float32)
    onpe = rng.integers(0, P, start.shape).astype(np.int32)
    valid = rng.uniform(size=start.shape) < 0.8
    nodes = rng.integers(0, 3, (D, P)).astype(np.int32)
    p_act = rng.uniform(0.1, 3.0, (D, P)).astype(np.float32)
    p_idle = rng.uniform(0.01, 0.2, (D, P)).astype(np.float32)
    makespan = np.where(valid, finish, 0).max(axis=(-1, -2)).astype(np.float32)
    out = dict(start=start, finish=finish, onpe=onpe, scheduled=valid,
               makespan_us=makespan)
    want = np.stack([np.asarray(jthermal.peak_temperature_grid(
        {k: v[f] for k, v in out.items()}, nodes, p_act, p_idle, bins=12,
        repeats=2)) for f in range(F)])
    t = torch.from_numpy
    got = peak_temperature_grid({k: t(v) for k, v in out.items()}, t(nodes),
                                t(p_act), t(p_idle), bins=12, repeats=2)
    assert got.shape == (F, D, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # one lane through the grid is the single-schedule pipeline
    trace, dt = tthermal.binned_power_trace(
        t(start[1, 2, 0]), t(finish[1, 2, 0]), t(onpe[1, 2, 0]),
        t(valid[1, 2, 0]), t(nodes[2]), t(p_act[2]), t(p_idle[2]),
        torch.tensor(makespan[1, 2, 0]), bins=12)
    np.testing.assert_allclose(float(tthermal.peak_temperature(trace, dt, 2)),
                               float(got[1, 2, 0]), rtol=1e-6)


def test_stack_policies_validates_as_the_reference():
    fields = dict(up_threshold=0.7, sample_window_us=30.0,
                  thermal_cap_c=30.0, thermal_dt_s=0.01)
    pols = [tdvfs.GovernorPolicy(dynamic=True, **fields),
            tdvfs.GovernorPolicy(dynamic=True, up_threshold=0.9)]
    lanes = tdvfs.stack_policies(pols)
    want = j_stack_policies([JPolicy(dynamic=True, **fields),
                             JPolicy(dynamic=True, up_threshold=0.9)])
    assert lanes.lanes == 2
    np.testing.assert_array_equal(lanes.window.numpy(),
                                  np.asarray(want.sample_window_us))
    np.testing.assert_array_equal(lanes.up.numpy(),
                                  np.asarray(want.up_threshold))
    np.testing.assert_array_equal(lanes.cap.numpy(),
                                  np.asarray(want.thermal_cap_c))
    assert torch.equal(lanes.take(torch.tensor([1, 1, 0])).up,
                       lanes.up[[1, 1, 0]])
    for bad, match in (([], "empty"),
                       ([tdvfs.GovernorPolicy()], "only dynamic"),
                       ([tdvfs.GovernorPolicy(dynamic=True,
                                              sample_window_us=0.0)],
                        "sample_window_us")):
        with pytest.raises(ValueError, match=match):
            tdvfs.stack_policies(bad)
        with pytest.raises(ValueError, match=match):
            j_stack_policies([JPolicy(**{f.name: getattr(p, f.name)
                                         for f in dataclasses.fields(p)})
                              for p in bad])
