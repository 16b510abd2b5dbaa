"""Closed-loop DTPM in the port's epoch scan (K1's plain version on the CPU)
against the JAX package: the non-sweep cases of tests/test_dtpm.py, fed
identical tables through ``tables_from_numpy``.

Tolerances: on the comm-free integer trace the schedule and the latched
frequency equal ``simulate_jax_dtpm`` and the event-heap reference bit for
bit.  With communication the schedule arrays (``scheduled``, ``start``,
``finish``, ``onpe``, ``onopp``, ``opp_idx``) are expected bit for bit
against ``simulate_jax_dtpm``; latency and makespan are held at 1e-4, energy
and ``peak_temp_c`` at 1e-5 relative: the window sums are exact fixed-point
sums in the port and f32 sums in XLA's order in the reference, and the RC
matrices come from torch's f32 ``exp`` instead of XLA's.  Against the
event-heap reference (float64 window sums) the reference's own tolerances
hold: 1e-4 on latency and makespan, 1e-3 on energy.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.applications import wifi_tx
from repro.core.dvfs import GovernorPolicy as JPolicy
from repro.core.dvfs import OndemandGovernor as JOndemand
from repro.core.dvfs import ondemand_index as j_ondemand_index
from repro.core.dvfs import throttle_index as j_throttle_index
from repro.core.jobgen import deterministic_trace, poisson_trace
from repro.core.resources import CPU_BIG, CPU_LITTLE, OPP_TABLE, CommModel
from repro.core.resources import make_soc_table2
from repro.core.schedulers import get_scheduler
from repro.core.simkernel_jax import build_tables, simulate_jax_dtpm
from repro.core.simkernel_ref import simulate as jref_simulate
from repro.core.thermal import exact_step_matrices_jax
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import run as jrun
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import simkernel_ref as tref
from repro_torch.core import simkernel_torch as skt
from repro_torch.core.applications import wifi_tx as t_wifi_tx
from repro_torch.core.jobgen import deterministic_trace as t_det_trace
from repro_torch.core.resources import CommModel as TCommModel
from repro_torch.core.resources import make_soc_table2 as t_soc
from repro_torch.core.schedulers import get_scheduler as t_get_scheduler
from repro_torch.dse import DesignPoint
from repro_torch.kernels import epoch_scan as k1
from repro_torch.kernels import ops
from repro_torch.scenario import Scenario, TraceSpec, run, tables_for

torch.set_num_threads(1)

SCHEDULE = ("scheduled", "start", "finish", "onpe", "onopp", "opp_idx")
SCN = dict(apps=("wifi_tx",),
           trace=dict(rate_jobs_per_ms=25.0, num_jobs=24, seed=3))
POLICY_FIELDS = ("dynamic", "up_threshold", "sample_window_us",
                 "thermal_cap_c", "thermal_dt_s")


def port_tables(tb):
    """The JAX package's tables, carried across as numpy."""
    return skt.tables_from_numpy(jax.tree_util.tree_map(np.asarray, tb),
                                 tb.t_max, tb.num_pes, "cpu")


def port_policy(pol):
    return tdvfs.GovernorPolicy(**{k: getattr(pol, k) for k in POLICY_FIELDS})


def comm_free_dbs():
    db, tdb = make_soc_table2(), t_soc()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    tdb.comm = TCommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    return db, tdb


def run_both(db, apps, trace, policy, gov):
    """simulate_jax_dtpm and the port's plain DTPM scan on the same tables."""
    tb = build_tables(db, apps, governor=gov)
    want = simulate_jax_dtpm(tb, policy, trace.arrival_us, trace.app_index,
                             gov.policy())
    got = skt.simulate_torch_dtpm(port_tables(tb), policy, trace.arrival_us,
                                  trace.app_index, port_policy(gov.policy()))
    assert set(got) == set(want)
    return tb, got, want


def assert_schedule_equal(got, want, keys=SCHEDULE):
    for key in keys:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def pair(spec, **kw):
    spec = dict(spec, **kw)
    trace = spec.pop("trace")
    return (Scenario(trace=TraceSpec(**trace), **spec),
            JScenario(trace=JTraceSpec(**trace), **spec))


# ------------------------------------------------ ref <-> jax <-> port

@pytest.mark.parametrize("policy", ["met", "etf"])
def test_ondemand_bitexact_on_tier1_trace(policy):
    """Comm-free integer latencies: the port's DTPM schedule and latched
    frequencies equal simulate_jax_dtpm, the reference's event-heap kernel
    and the port's own, bit for bit."""
    db, tdb = comm_free_dbs()
    trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    gov = JOndemand(sample_window_us=50.0)
    tb, got, want = run_both(db, [wifi_tx()], trace, policy, gov)
    assert_schedule_equal(got, want)
    assert float(got["peak_temp_c"]) == float(want["peak_temp_c"])
    fin, onpe, onopp = (got[k].numpy() for k in ("finish", "onpe", "onopp"))
    opp_freq = np.asarray(tb.opp_freq)
    pe_domain = np.asarray(tb.pe_domain)
    ref = jref_simulate(db, [wifi_tx()], trace, get_scheduler(policy), gov)
    tgov = tdvfs.OndemandGovernor(sample_window_us=50.0)
    port_ref = tref.simulate(tdb, [t_wifi_tx()], t_det_trace(25.0, 64, ["wifi_tx"]),
                             t_get_scheduler(policy), tgov)
    assert ref.records and len(port_ref.records) == len(ref.records)
    for r, pr in zip(ref.records, port_ref.records):
        assert (r.job_id, r.task_id, r.pe_id, r.finish_us, r.freq_ghz) == \
            (pr.job_id, pr.task_id, pr.pe_id, pr.finish_us, pr.freq_ghz)
        assert fin[r.job_id, r.task_id] == np.float32(r.finish_us)
        assert onpe[r.job_id, r.task_id] == r.pe_id
        if db.pes[r.pe_id].is_cpu:
            f = opp_freq[pe_domain[r.pe_id], onopp[r.job_id, r.task_id]]
            assert f == np.float32(r.freq_ghz)


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
@pytest.mark.parametrize("rate,seed", [(60.0, 0), (20.0, 3)])
def test_kernels_agree_with_comm(rate, seed, governor):
    db = make_soc_table2()
    app = wifi_tx()
    trace = poisson_trace(rate, 100, ["wifi_tx"], seed=seed)
    gov = (JOndemand() if governor == "ondemand"
           else JOndemand(thermal_cap_c=27.0, thermal_dt_s=0.05))
    _, got, want = run_both(db, [app], trace, "etf", gov)
    assert_schedule_equal(got, want)
    for key, tol in (("avg_job_latency_us", 1e-4), ("makespan_us", 1e-4),
                     ("energy_j", 1e-5), ("peak_temp_c", 1e-5)):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=tol, err_msg=key)
    ref = jref_simulate(db, [app], trace, get_scheduler("etf"), gov)
    np.testing.assert_allclose(float(got["avg_job_latency_us"]),
                               ref.avg_job_latency_us, rtol=1e-4)
    np.testing.assert_allclose(float(got["makespan_us"]), ref.makespan_us,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["energy_j"]),
                               ref.energy.total_energy_j, rtol=1e-3)


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
@pytest.mark.parametrize("policy", ["met", "etf", "table"])
def test_run_facade_dynamic_backends_agree(governor, policy):
    tscn, jscn = pair(SCN, governor=governor, scheduler=policy)
    got = run(tscn, backend="torch", device="cpu")
    want = jrun(jscn, backend="jax")
    assert got.backend == "torch"
    assert got.makespan_us == want.makespan_us
    for name, tol in (("avg_latency_us", 1e-6), ("throughput_jobs_per_ms", 1e-6),
                      ("energy_j", 1e-5), ("avg_power_w", 1e-5),
                      ("peak_temp_c", 1e-5)):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=tol, err_msg=name)
    assert_schedule_equal(got.raw, want.raw)
    ref = run(tscn, backend="ref")
    np.testing.assert_allclose(got.avg_latency_us, ref.avg_latency_us,
                               rtol=1e-4)
    np.testing.assert_allclose(got.energy_j, ref.energy_j, rtol=1e-3)


def test_ondemand_ramps_in_the_port():
    """Under load the scan leaves fmin — the loop really closes."""
    db = make_soc_table2()
    trace = poisson_trace(60.0, 300, ["wifi_tx"], seed=0)
    gov = JOndemand()
    _, got, want = run_both(db, [wifi_tx()], trace, "etf", gov)
    assert_schedule_equal(got, want)
    onopp = got["onopp"].numpy()
    big = [j for j, pe in enumerate(db.pes) if pe.pe_type == CPU_BIG]
    mask = np.isin(got["onpe"].numpy(), big) & got["scheduled"].numpy()
    assert onopp[mask].min() == 0                       # starts at fmin
    assert onopp[mask].max() == len(OPP_TABLE[CPU_BIG]) - 1   # reaches fmax


# ------------------------------------------------ governor transition

def test_ondemand_index_torch_equals_the_reference():
    """The tensor transition equals the numpy one on every ladder, threshold
    and utilisation of a fine grid, the f32 1e-9 slack at util 0 included."""
    utils = np.concatenate([np.linspace(0.0, 1.2, 241), [0.8, 0.95, 1.0]])
    utils = utils.astype(np.float32)
    for caps in (None, {CPU_BIG: 1.0, CPU_LITTLE: 0.6}):
        ladders = [tdvfs.padded_ladder(t, caps) for t in (CPU_BIG, CPU_LITTLE)]
        opp_freq = np.asarray([row for _, row, _ in ladders], np.float32)
        num_opp = np.asarray([n for _, _, n in ladders], np.int32)
        for up in (0.5, 0.8, 0.95, 1.0):
            util = np.stack([utils, utils[::-1]], axis=1)            # (N, 2)
            up32 = np.float32(up)
            want = np.stack([j_ondemand_index(opp_freq, num_opp, up32, u)
                             for u in util])
            got = tdvfs.ondemand_index_torch(
                torch.from_numpy(opp_freq), torch.from_numpy(num_opp),
                torch.full((len(util),), up32), torch.from_numpy(util))
            np.testing.assert_array_equal(got.numpy(), want)


def test_throttle_index_torch_clamps_hot_domains():
    idx = torch.tensor([[4, 2, 0]])
    temps = torch.tensor([[80.0, 40.0, 90.0]])
    out = tdvfs.throttle_index_torch(idx, temps, torch.tensor([60.0]))
    np.testing.assert_array_equal(out.numpy(), [[0, 2, 0]])
    np.testing.assert_array_equal(
        j_throttle_index(idx.numpy()[0], temps.numpy()[0], 60.0), [0, 2, 0])
    # an infinite cap disables the override
    out = tdvfs.throttle_index_torch(idx, temps, torch.tensor([np.inf]))
    np.testing.assert_array_equal(out.numpy(), idx.numpy())


def test_policy_lanes_match_the_reference_rc_step():
    pols = [tdvfs.ThrottleGovernor().policy(), tdvfs.OndemandGovernor().policy()]
    lanes = tdvfs.policy_lanes(pols, 2)
    assert lanes.lanes == 2
    np.testing.assert_array_equal(lanes.window.numpy(), [50.0, 50.0])
    np.testing.assert_array_equal(lanes.up.numpy(), np.float32([0.8, 0.8]))
    assert lanes.cap[0] == 60.0 and torch.isinf(lanes.cap[1])
    for k, pol in enumerate(pols):
        jA, jB = jax.jit(exact_step_matrices_jax)(np.float32(pol.thermal_dt_s))
        for got, want in ((lanes.A_rc[k], jA), (lanes.B_rc[k], jB)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    one = tdvfs.policy_lanes(pols[0], 3)
    assert torch.equal(one.A_rc[2], lanes.A_rc[0])


# ------------------------------------------------ guards

def test_kernel_table_and_window_guards():
    """Mismatched tables and degenerate policies fail fast instead of
    computing fmin-pinned results or hanging the window loop."""
    db = make_soc_table2()
    trace = poisson_trace(20.0, 8, ["wifi_tx"], seed=0)
    dyn = port_tables(build_tables(db, [wifi_tx()], governor=JOndemand()))
    static = port_tables(build_tables(db, [wifi_tx()]))
    args = (trace.arrival_us, trace.app_index)
    ondemand = tdvfs.OndemandGovernor().policy()
    with pytest.raises(ValueError, match="dynamic governor"):
        skt.simulate_torch(dyn, "etf", *args)
    with pytest.raises(ValueError, match="OPP ladders"):
        skt.simulate_torch_dtpm(static, "etf", *args, ondemand)
    with pytest.raises(ValueError, match="static governors"):
        skt.simulate_torch_dtpm(dyn, "etf", *args, tdvfs.GovernorPolicy())
    with pytest.raises(ValueError, match="positive"):
        tdvfs.OndemandGovernor(sample_window_us=0.0)
    with pytest.raises(ValueError, match="positive"):
        skt.simulate_torch_dtpm(dyn, "etf", *args, tdvfs.GovernorPolicy(
            dynamic=True, sample_window_us=0.0))
    with pytest.raises(ValueError, match="up_threshold"):
        skt.simulate_torch_dtpm(dyn, "etf", *args, tdvfs.GovernorPolicy(
            dynamic=True, up_threshold=0.0))
    with pytest.raises(ValueError, match="thermal_dt_s"):
        skt.simulate_batch_dtpm(dyn, "etf", args[0][None], args[1][None],
                                [tdvfs.GovernorPolicy(dynamic=True,
                                                      thermal_dt_s=-1.0)])
    with pytest.raises(ValueError, match="2 policies for 1 lanes"):
        skt.simulate_batch_dtpm(dyn, "etf", args[0][None], args[1][None],
                                [ondemand, ondemand])
    with pytest.raises(ValueError, match="PE-masking"):
        skt.simulate_torch_dtpm(dyn, "table", *args, ondemand,
                                faults=np.full(db.num_pes, np.inf, np.float32))
    # the reference's own guards on the same inputs
    with pytest.raises(ValueError, match="positive"):
        simulate_jax_dtpm(build_tables(db, [wifi_tx()], governor=JOndemand()),
                          "etf", *args, JPolicy(dynamic=True,
                                                sample_window_us=0.0))


def test_run_torch_still_refuses_faults_and_telemetry_under_dtpm():
    """Faults under DTPM run (tests/test_torch_faults.py holds them to the
    reference); with the table scheduler, or with telemetry, they raise, as
    the reference's jax backend does.  Telemetry without faults runs
    (tests/test_torch_obs.py holds it)."""
    from repro_torch.scenario import BackendCapabilityError, FaultSpec
    scn = Scenario(governor="throttle",
                   trace=TraceSpec(rate_jobs_per_ms=25.0, num_jobs=12, seed=3))
    faulted = scn.replace(failures=(FaultSpec(0, 100.0),))
    assert run(faulted, device="cpu").raw["steps"] > 0
    with pytest.raises(BackendCapabilityError, match="'table' scheduler"):
        run(faulted.replace(scheduler="table"), device="cpu")
    with pytest.raises(BackendCapabilityError,
                       match="telemetry with faults under a dynamic governor"):
        run(faulted.replace(telemetry=True), device="cpu")
    assert run(scn.replace(telemetry=True), device="cpu").telemetry \
        .num_windows > 0


# ------------------------------------------------ thermal throttle

THROTTLE = dict(apps=("wifi_tx",),
                trace=dict(rate_jobs_per_ms=60.0, num_jobs=300, seed=0))
THROTTLE_PARAMS = (("sample_window_us", 50.0), ("thermal_dt_s", 0.2))


def test_throttle_cap_bounds_peak_temperature():
    """The cap bounds the inline RC peak within one window's overshoot, and
    throttling trades latency for temperature, as in the reference."""
    cap = 30.0
    free_t, free_j = pair(THROTTLE, governor="ondemand",
                          governor_params=THROTTLE_PARAMS)
    capped_t, capped_j = pair(THROTTLE, governor="ondemand",
                              governor_params=THROTTLE_PARAMS
                              + (("thermal_cap_c", cap),))
    free = run(free_t, device="cpu")
    capped = run(capped_t, device="cpu")
    assert free.peak_temp_c > cap          # the cap binds on this workload
    assert capped.peak_temp_c <= cap + 3.0       # one-window overshoot slack
    assert capped.peak_temp_c < free.peak_temp_c
    assert capped.avg_latency_us >= free.avg_latency_us
    for got, want in ((free, jrun(free_j, backend="jax")),
                      (capped, jrun(capped_j, backend="jax"))):
        np.testing.assert_allclose(got.peak_temp_c, want.peak_temp_c,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.avg_latency_us, want.avg_latency_us,
                                   rtol=1e-4)


def test_throttle_ref_kernel_agrees():
    tscn, jscn = pair(THROTTLE, governor="ondemand",
                      governor_params=THROTTLE_PARAMS + (("thermal_cap_c", 30.0),))
    got = run(tscn, device="cpu")
    np.testing.assert_allclose(got.avg_latency_us,
                               run(tscn, backend="ref").avg_latency_us,
                               rtol=1e-4)
    np.testing.assert_allclose(got.avg_latency_us,
                               jrun(jscn, backend="jax").avg_latency_us,
                               rtol=1e-4)


# ------------------------------------------------ design frequency caps

def test_dynamic_governor_respects_design_freq_caps():
    """A design's frequency caps bound the ondemand ladder: the tables, the
    latched OPPs and the port's event-heap reference agree on the capped set
    (tests/test_dtpm.py's case without its dse.evaluate part)."""
    from repro.dse import DesignPoint as JDesignPoint
    point = (4, 4, 2, 4, 0)
    tscn, jscn = pair(SCN, governor="ondemand")
    tscn = tscn.replace(design=DesignPoint(*point, big_freq_ghz=1.0),
                        **{"trace.rate_jobs_per_ms": 60.0,
                           "trace.num_jobs": 120})
    jscn = jscn.replace(design=JDesignPoint(*point, big_freq_ghz=1.0),
                        **{"trace.rate_jobs_per_ms": 60.0,
                           "trace.num_jobs": 120})
    res = run(tscn, device="cpu")
    tables = tables_for(tscn, device="cpu")
    big_levels = [f for f, _ in OPP_TABLE[CPU_BIG]]
    capped = sum(f <= 1.0 + 1e-9 for f in big_levels)
    assert int(tables.num_opp[0]) == capped
    onopp, onpe = res.raw["onopp"].numpy(), res.raw["onpe"].numpy()
    big = [j for j, pe in enumerate(tscn.soc().pes) if pe.pe_type == CPU_BIG]
    mask = np.isin(onpe, big) & res.raw["scheduled"].numpy()
    assert onopp[mask].max() <= capped - 1
    ref = run(tscn, backend="ref")
    assert max(r.freq_ghz for r in ref.raw.records
               if tscn.soc().pes[r.pe_id].pe_type == CPU_BIG) <= 1.0 + 1e-9
    np.testing.assert_allclose(res.avg_latency_us, ref.avg_latency_us,
                               rtol=1e-4)
    want = jrun(jscn, backend="jax")
    assert_schedule_equal(res.raw, want.raw)


# ------------------------------------------------ lanes and the wrapper

def test_lanes_with_different_policies_equal_their_single_runs():
    """One plain call over lanes whose policies differ (up threshold, window,
    cap, RC step) gives each lane what its single-lane run gives."""
    db = make_soc_table2()
    tt = port_tables(build_tables(db, [wifi_tx()], governor=JOndemand()))
    pols = [tdvfs.GovernorPolicy(dynamic=True, up_threshold=u,
                                 sample_window_us=w, thermal_cap_c=c,
                                 thermal_dt_s=dt)
            for u, w, c, dt in ((0.6, 25.0, np.inf, 25e-6),
                                (0.8, 50.0, 27.0, 0.05),
                                (0.95, 100.0, 26.0, 0.2))]
    traces = [poisson_trace(r, 40, ["wifi_tx"], seed=s)
              for r, s in ((20.0, 0), (60.0, 1), (40.0, 2))]
    arr = np.stack([t.arrival_us for t in traces])
    idx = np.stack([t.app_index for t in traces])
    batch = skt.simulate_batch_dtpm(tt, "etf", arr, idx, pols)
    for k, (pol, t) in enumerate(zip(pols, traces)):
        single = skt.simulate_torch_dtpm(tt, "etf", t.arrival_us, t.app_index,
                                         pol)
        for key in single:
            assert torch.equal(single[key], batch[key][k]), (k, key)
        jx = simulate_jax_dtpm(build_tables(db, [wifi_tx()],
                                            governor=JOndemand()),
                               "etf", t.arrival_us, t.app_index,
                               JPolicy(**{f: getattr(pol, f)
                                          for f in POLICY_FIELDS}))
        assert_schedule_equal(single, jx)


def test_cpu_tensors_take_the_plain_dtpm_version_and_count_no_launch():
    db = make_soc_table2()
    tt = port_tables(build_tables(db, [wifi_tx()], governor=JOndemand()))
    trace = poisson_trace(10.0, 12, ["wifi_tx"], seed=2)
    arr = torch.from_numpy(trace.arrival_us)[None]
    idx = torch.from_numpy(trace.app_index)[None]
    gov = tdvfs.policy_lanes(tdvfs.OndemandGovernor().policy(), 1)
    before = k1.launches
    got = ops.epoch_scan(tt, "etf", arr, idx, gov=gov)
    want = k1.epoch_scan_plain(tt, "etf", arr, idx, gov)
    assert k1.launches == before
    assert len(got) == 7
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    C = tt.opp_freq.shape[0]
    assert got[4].shape == got[0].shape and got[5].shape == (1, C)
    assert got[6].shape == (1,)


def test_window_sums_are_exact_and_the_shared_layout_adds_up():
    """The fixed-point window sums do not depend on the order of the cells,
    and K1's DTPM shared-memory size is the static one plus what the tables
    and the carry add."""
    rng = np.random.default_rng(0)
    terms = torch.from_numpy(rng.uniform(0, 50, (2, 200)).astype(np.float32))
    index = torch.from_numpy(rng.integers(0, 5, (2, 200)))
    scale = torch.tensor([[2.0 ** 42], [2.0 ** 42]])
    sums = k1.fixed_sums(terms, scale, index, 5)
    perm = torch.from_numpy(rng.permutation(200))
    assert torch.equal(sums, k1.fixed_sums(terms[:, perm], scale,
                                           index[:, perm], 5))
    exact = np.zeros((2, 5))
    np.add.at(exact, (np.arange(2)[:, None], index.numpy()),
              terms.numpy().astype(np.float64))
    np.testing.assert_allclose(sums.numpy() / 2.0 ** 42, exact, rtol=1e-12)
    q = k1.quanta(torch.tensor([50.0, 25.0]), 3.0)
    assert q.tolist() == [[41, 39], [42, 40]]
    static = k1.shared_bytes(1000, 5, 8, 15)
    P, C, K, J = 15, 3, 5, 1000
    assert k1.shared_bytes(1000, 5, 8, 15, C, K) == static + 4 * (
        # the tables: the OPP latencies, powers, ladders, domain and node
        # maps, rounded up to 8 bytes
        5 * 8 * 15 * (K - 1) + P * K + C * K + 3 * C + 4 * P + 1
        # a lane: busy bins (int64), list heads and tails, OPPs, RC, carry
        + 4 * P + C + 32 + 7)
    assert k1.shared_bytes(J, 5, 8, 15, C, K, True) == k1.shared_bytes(
        J, 5, 8, 15, C, K) + 4 * (4 * P + J)     # fail times, PE masks, floors
