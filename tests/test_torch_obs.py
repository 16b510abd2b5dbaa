"""``repro_torch.obs`` on the CPU: the twins of tests/test_obs.py.

Both packages get the same inputs (scenarios and job traces made with numpy
from a seed): the JAX side through ``repro``, the port through
``device="cpu"`` (K1's plain version).  Contracts pinned here:

* **telemetry equality** — the port's DTPM replay against the JAX package's
  (``jax_dtpm_telemetry``): ``freq_idx`` and ``freq_ghz`` equal, util,
  power and temperatures within 1e-5 relative (atol 1e-6); against the
  port's own in-loop recorder within tests/test_obs.py's 1e-4; the
  replayed peak equal to the scan's ``peak_temp_c`` bit for bit; static
  governors likewise against ``jax_static_telemetry``, and the two
  packages' event-heap recorders and numpy static replays exactly equal;
* **zero overhead** — ``telemetry=True`` starts the scan exactly as often
  and leaves its outputs the same bits;
* **the manifest** names the device the run used;
* **sweep lanes** equal their ``run`` bit for bit (DTPM, static, faults,
  ref); **artifacts** — JSON round trip across the two packages, the Chrome
  trace (equal to the reference's on the same run), the validator, the
  bench CLI and the report CLI.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core import dvfs as jdvfs
from repro.core.applications import wifi_tx as jwifi_tx
from repro.core.jobgen import deterministic_trace as jdeterministic
from repro.core.resources import CommModel as JCommModel
from repro.core.resources import make_soc_table2 as jsoc
from repro.core.schedulers import get_scheduler as jget_sched
from repro.core.simkernel_jax import build_tables as jbuild
from repro.core.simkernel_jax import simulate_jax, simulate_jax_dtpm
from repro.core.simkernel_ref import simulate as jsimulate
from repro.obs import chrome_trace as jchrome_trace
from repro.obs import telemetry as jtel
from repro.obs.bench import rows_payload as jrows_payload
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import run as jrun
from repro.scenario import sweep as jsweep
from repro_torch.core import dvfs as tdvfs
from repro_torch.core.applications import wifi_tx
from repro_torch.core.jobgen import deterministic_trace
from repro_torch.core.resources import CommModel, make_soc_table2
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.simkernel_ref import simulate
from repro_torch.core.simkernel_torch import (build_tables, simulate_torch,
                                              simulate_torch_dtpm)
from repro_torch.kernels import epoch_scan as k1
from repro_torch.kernels import ops
from repro_torch.obs import (Telemetry, TelemetryRecorder, bench_cli,
                             chrome_trace, metrics, validate_chrome_trace,
                             write_chrome_trace)
from repro_torch.obs import report
from repro_torch.obs.bench import BENCH_SCHEMA, rows_payload
from repro_torch.obs.metrics import MANIFEST_SCHEMA
from repro_torch.obs.telemetry import (TELEMETRY_SCHEMA, domain_count,
                                       num_windows_for, ref_static_telemetry,
                                       static_freq_columns,
                                       torch_dtpm_telemetry,
                                       torch_static_telemetry)
from repro_torch.scenario import FaultSpec, Scenario, TraceSpec, run, sweep

# the module (the package's `sweep` attribute is the function)
sweep_mod = importlib.import_module("repro_torch.scenario.sweep")

torch.set_num_threads(1)

TRACE = dict(rate_jobs_per_ms=25.0, num_jobs=24, seed=3)
SCN = Scenario(apps=("wifi_tx",), trace=TraceSpec(**TRACE))
JSCN = JScenario(apps=("wifi_tx",), trace=JTraceSpec(**TRACE))
FIELDS = ("util", "power_w", "temps_c")
THROTTLE = dict(thermal_cap_c=27.0, thermal_dt_s=0.05)


def _comm_free_dbs():
    jdb, tdb = jsoc(), make_soc_table2()
    jdb.comm = JCommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    tdb.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    return jdb, tdb


def _assert_close(got: Telemetry, want, rtol, atol=1e-6, what=""):
    """freq_idx equal, freq_ghz equal, the rest within ``rtol``."""
    assert got.num_windows == want.num_windows > 0, what
    assert got.num_domains == want.num_domains, what
    np.testing.assert_array_equal(got.freq_idx, want.freq_idx, err_msg=what)
    np.testing.assert_array_equal(got.freq_ghz, want.freq_ghz, err_msg=what)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {f}")


def _lane(out, keys=("scheduled", "start", "finish", "onpe", "onopp",
                     "makespan_us")):
    """One simulation's outputs as a one-lane launch's."""
    return {k: out[k][None] for k in keys if k in out}


def _dtpm_pair(governor: str, jobs: int = 64):
    """The comm-free integer trace of tests/test_obs.py through both DTPM
    scans: (port tables, port out, JAX tables, JAX out, trace, policies)."""
    jdb, tdb = _comm_free_dbs()
    kw = THROTTLE if governor == "throttle" else {}
    jgov = jdvfs.get_governor(governor, sample_window_us=50.0, **kw)
    tgov = tdvfs.get_governor(governor, sample_window_us=50.0, **kw)
    jtrace = jdeterministic(25.0, jobs, ["wifi_tx"])
    trace = deterministic_trace(25.0, jobs, ["wifi_tx"])
    jtb = jbuild(jdb, [jwifi_tx()], governor=jgov)
    ttb = build_tables(tdb, [wifi_tx()], governor=tgov, device="cpu")
    jout = simulate_jax_dtpm(jtb, "etf", jtrace.arrival_us, jtrace.app_index,
                             jgov.policy())
    tout = simulate_torch_dtpm(ttb, "etf", trace.arrival_us, trace.app_index,
                               tgov.policy())
    return ttb, tout, jtb, jout, trace, jtrace, tgov, jgov, tdb


# ------------------------------------------------ metrics registry

def test_counter_and_timer_registry():
    c = metrics.counter("test_torch_obs.count")
    assert metrics.counter("test_torch_obs.count") is c   # registry identity
    c.reset()
    assert c.inc() == 1 and c.inc(3) == 4
    assert c.value == 4 and int(c) == 4
    t = metrics.timer("test_torch_obs.timer")
    with t:
        pass
    assert t.count >= 1 and t.last_s >= 0.0
    assert t.last_us == t.last_s * 1e6
    snap = metrics.snapshot()
    assert snap["counters"]["test_torch_obs.count"] == 4
    assert "test_torch_obs.timer" in snap["timers"]


def test_sweep_scan_calls_stand_where_compile_count_stands():
    """No traces here: the manifest carries the sweep's grid scans and K1's
    launches, both keyed by K1's instantiation names."""
    man = metrics.run_manifest()
    names = set(k1.VARIANT_NAMES.values())
    assert set(man["scan_calls"]) == set(man["k1_launches"]) == names
    before = man["scan_calls"]["epoch_scan"]
    sweep(SCN, axes={"seed": [0, 1]}, device="cpu")
    assert metrics.run_manifest()["scan_calls"]["epoch_scan"] == before + 1
    assert sum(sweep_mod.scan_calls.values()) \
        == sum(metrics.run_manifest()["scan_calls"].values())
    assert "jit_compile_count" not in man


def test_window_sizing_helpers():
    for m, w in ((100.0, 50.0), (101.0, 50.0), (0.0, 50.0), (999.9, 33.3),
                 (50.0 * 1000, 50.0), (7.0, 0.0)):
        assert num_windows_for(m, w) == jtel.num_windows_for(m, w)
    assert num_windows_for(100.0, 50.0) == 2 and num_windows_for(101.0, 50.0) == 3
    assert not hasattr(importlib.import_module("repro_torch.obs.telemetry"),
                       "_bucket_pow2")


# ------------------------------------------------ telemetry equality

@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
def test_dtpm_telemetry_replay_equals_jax_replay(governor):
    """The port's replay over its scan's schedule against the JAX package's
    replay over its own (the two schedules are equal bit for bit): the same
    OPP in every window, the rest within 1e-5; the replayed peak is the
    scan's ``peak_temp_c`` bit for bit."""
    ttb, tout, jtb, jout, trace, jtrace, tgov, jgov, _ = _dtpm_pair(governor)
    got = torch_dtpm_telemetry(ttb, tgov.policy(), _lane(tout),
                               trace.app_index[None])[0]
    want = jtel.jax_dtpm_telemetry(jtb, jgov.policy(), jout,
                                   jtrace.app_index)
    _assert_close(got, want, 1e-5, what=governor)
    assert got.num_windows == num_windows_for(float(tout["makespan_us"]), 50.0)
    assert got.peak_temp_c == float(tout["peak_temp_c"])
    assert got.freq_idx.dtype == np.int32 and got.util.dtype == np.float32
    if governor == "throttle":
        assert got.freq_idx.min() == 0 and got.peak_temp_c > 27.0


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
def test_dtpm_telemetry_replay_equals_the_ref_recorder(governor):
    """The port's replay against the port's in-loop recorder of the
    event-heap kernel on the same comm-free trace (tests/test_obs.py's
    tolerances)."""
    ttb, tout, _, _, trace, _, tgov, _, tdb = _dtpm_pair(governor)
    got = torch_dtpm_telemetry(ttb, tgov.policy(), _lane(tout),
                               trace.app_index[None])[0]
    rec = TelemetryRecorder(tgov.sample_window_us)
    ref = simulate(tdb, [wifi_tx()], trace, get_scheduler("etf"), tgov,
                   telemetry=rec)
    want = rec.build(domain_count(tdb))
    assert want.num_windows == num_windows_for(ref.makespan_us, 50.0)
    np.testing.assert_array_equal(got.freq_idx, want.freq_idx)
    np.testing.assert_allclose(got.freq_ghz, want.freq_ghz, rtol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.peak_temp_c, want.peak_temp_c, rtol=1e-4)


@pytest.mark.parametrize("governor", ["ondemand", "throttle"])
@pytest.mark.parametrize("rate", [5.0, 20.0, 80.0])
def test_replayed_peak_is_the_scans_bit_for_bit(governor, rate):
    """Loaded and idle traces through ``run``: every lane's replayed peak
    equals the scan's inline ``peak_temp_c`` exactly, and the window count
    is ``num_windows_for`` of the makespan."""
    scn = Scenario(apps=("wifi_tx", "wifi_rx"), scheduler="met",
                   governor=governor,
                   governor_params=tuple(THROTTLE.items())
                   if governor == "throttle" else (),
                   trace=TraceSpec(rate_jobs_per_ms=rate, num_jobs=30,
                                   seed=int(rate)))
    res = run(scn, device="cpu", telemetry=True)
    window = scn.make_policy().sample_window_us
    assert res.telemetry.num_windows == num_windows_for(res.makespan_us, window)
    assert res.telemetry.peak_temp_c == res.peak_temp_c


def test_static_telemetry_replay_equals_jax_and_ref():
    """Static governor: the port's replay against ``jax_static_telemetry``
    (frequency columns equal, the rest 1e-5) and against its numpy replay of
    the event-heap run (1e-4); the two packages' numpy replays are the same
    numbers exactly."""
    jdb, tdb = _comm_free_dbs()
    jgov, tgov = jdvfs.get_governor("performance"), tdvfs.get_governor(
        "performance")
    jtrace = jdeterministic(25.0, 64, ["wifi_tx"])
    trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    jtb = jbuild(jdb, [jwifi_tx()], governor=jgov)
    ttb = build_tables(tdb, [wifi_tx()], governor=tgov, device="cpu")
    jout = simulate_jax(jtb, "etf", jtrace.arrival_us, jtrace.app_index)
    tout = simulate_torch(ttb, "etf", trace.arrival_us, trace.app_index)
    cols = static_freq_columns(tdb, tgov, domain_count(tdb))
    got = torch_static_telemetry(ttb, _lane(tout), trace.app_index[None],
                                 [cols])[0]
    want = jtel.jax_static_telemetry(jdb, jgov, jtb, jout, jtrace.app_index)
    _assert_close(got, want, 1e-5, what="static vs jax")
    ref = simulate(tdb, [wifi_tx()], trace, get_scheduler("etf"), tgov)
    mine = ref_static_telemetry(tdb, ref, tgov)
    _assert_close(got, mine, 1e-4, what="static vs ref")
    theirs = jtel.ref_static_telemetry(
        jdb, jsimulate(jdb, [jwifi_tx()], jtrace, jget_sched("etf"), jgov),
        jgov)
    assert mine.equals(theirs)


def test_ref_recorders_of_both_packages_are_equal():
    """The same numpy code on the same event-heap run: the two packages'
    recorders build the same arrays, bit for bit."""
    jdb, tdb = _comm_free_dbs()
    jgov = jdvfs.get_governor("throttle", **THROTTLE)
    tgov = tdvfs.get_governor("throttle", **THROTTLE)
    jrec = jtel.TelemetryRecorder(jgov.sample_window_us)
    trec = TelemetryRecorder(tgov.sample_window_us)
    jsimulate(jdb, [jwifi_tx()], jdeterministic(25.0, 48, ["wifi_tx"]),
              jget_sched("met"), jgov, telemetry=jrec)
    simulate(tdb, [wifi_tx()], deterministic_trace(25.0, 48, ["wifi_tx"]),
             get_scheduler("met"), tgov, telemetry=trec)
    got, want = trec.build(3), jrec.build(3)
    assert got.num_windows > 0 and got.equals(want)


@pytest.mark.parametrize("governor", ["performance", "ondemand", "throttle"])
def test_run_telemetry_equals_the_reference_run(governor):
    """The slice end to end: ``run(telemetry=True)`` of the port against the
    reference's jax backend (1e-5), and on ``backend="ref"`` the two
    packages' timelines exactly."""
    params = tuple(THROTTLE.items()) if governor == "throttle" else ()
    tscn = SCN.replace(governor=governor, governor_params=params)
    jscn = JSCN.replace(governor=governor, governor_params=params)
    got = run(tscn, device="cpu", telemetry=True).telemetry
    want = jrun(jscn, backend="jax", telemetry=True).telemetry
    _assert_close(got, want, 1e-5, what=governor)
    got_ref = run(tscn, backend="ref", telemetry=True).telemetry
    assert got_ref.equals(jrun(jscn, backend="ref", telemetry=True).telemetry)


@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_telemetry_is_zero_overhead(governor, monkeypatch):
    """``telemetry=True`` must not touch the simulation: the scan starts
    once either way, its outputs are the same bits, K1's launch counters
    and the sweep's scan count do not move."""
    calls = []
    scan = ops.epoch_scan

    def counted(*args, **kw):
        calls.append(1)
        return scan(*args, **kw)
    monkeypatch.setattr(ops, "epoch_scan", counted)
    scn = SCN.replace(governor=governor)
    r0 = run(scn, device="cpu")
    assert r0.telemetry is None and len(calls) == 1
    before = (k1.launches, dict(k1.variant_launches),
              dict(sweep_mod.scan_calls))
    r1 = run(scn, device="cpu", telemetry=True)
    assert len(calls) == 2
    assert (k1.launches, k1.variant_launches, sweep_mod.scan_calls) == before
    assert r1.telemetry is not None
    for key, v in r0.raw.items():
        assert torch.equal(v, r1.raw[key]), key
    assert (r0.avg_latency_us, r0.energy_j, r0.peak_temp_c) \
        == (r1.avg_latency_us, r1.energy_j, r1.peak_temp_c)
    r2 = run(scn.replace(telemetry=True), device="cpu")
    assert r2.telemetry.equals(r1.telemetry)
    assert r1.manifest["k1_launches"] == r0.manifest["k1_launches"]


def test_result_manifest_attached():
    for backend in ("ref", "torch"):
        man = run(SCN, backend=backend, device="cpu").manifest
        assert man["schema"] == MANIFEST_SCHEMA == "repro.obs/manifest/v1"
        assert man["backend"] == backend
        assert man["scenario"] == SCN.label() == JSCN.label()
        assert len(man["scenario_hash"]) == 12
        assert man["torch_version"] == torch.__version__
        assert man["cuda_version"] == torch.version.cuda
        # the device the run used, whatever this box has
        assert (man["device_platform"], man["device_kind"],
                man["device_count"]) == ("cpu", "cpu", 1)
        assert set(man["k1_launches"]) == set(k1.VARIANT_NAMES.values())
        assert "counters" in man["metrics"] and "timers" in man["metrics"]
        assert "timestamp" in man and "jax_version" not in man
        json.dumps(man)
    assert "device_platform" not in metrics.run_manifest()


# ------------------------------------------------ sweep lanes

def test_sweep_telemetry_lanes_match_run():
    """DTPM sweep timelines are one replay of the grid's lanes: every lane
    equals its ``run(..., telemetry=True)`` bit for bit, and the JAX
    package's sweep lane within 1e-5."""
    scn, jscn = SCN.replace(governor="ondemand"), JSCN.replace(
        governor="ondemand")
    params = [(("up_threshold", 0.6),), (("up_threshold", 0.9),
                                         ("sample_window_us", 25.0))]
    axes = {"governor_params": params, "seed": [0, 1]}
    sr = sweep(scn, axes=axes, device="cpu", telemetry=True)
    jsr = jsweep(jscn, axes=axes, backend="jax", telemetry=True)
    assert sr.telemetry.shape == (2, 2)
    for g in (0, 1):
        for s in (0, 1):
            single = run(scn.replace(governor_params=params[g]).with_seed(s),
                         device="cpu", telemetry=True)
            lane = sr.telemetry[g, s]
            assert isinstance(lane, Telemetry)
            assert lane.equals(single.telemetry), (g, s)
            _assert_close(lane, jsr.telemetry[g, s], 1e-5, what=f"{g} {s}")
    assert sweep(scn, axes={"governor_params": params[:1]},
                 device="cpu").telemetry is None


def test_sweep_telemetry_static_fault_and_ref_lanes():
    """Static lanes on stacked designs and fault lanes (prepended, as the
    reference's) equal their ``run``; ref lanes come from ``run``."""
    from repro_torch.dse import DesignPoint
    points = [DesignPoint(), DesignPoint(num_fft=1, num_vit=1),
              DesignPoint(cross_cluster_penalty=2.0)]
    fs = [(), (FaultSpec(0, 300.0),)]
    base = SCN.replace(governor="design")
    sr = sweep(base, axes={"faults": fs, "design": points, "seed": [0, 1]},
               device="cpu", telemetry=True)
    assert sr.telemetry.shape == (2, 3, 2)
    for f in (0, 1):
        for d in range(3):
            for s in (0, 1):
                single = run(base.replace(failures=fs[f], design=points[d])
                             .with_seed(s), device="cpu", telemetry=True)
                assert sr.telemetry[f, d, s].equals(single.telemetry), (f, d, s)
    jsr = jsweep(JSCN, axes={"seed": [0, 1]}, backend="jax", telemetry=True)
    tsr = sweep(SCN, axes={"seed": [0, 1]}, device="cpu", telemetry=True)
    for s in (0, 1):
        _assert_close(tsr.telemetry[s], jsr.telemetry[s], 1e-5)
    sr_ref = sweep(SCN, axes={"seed": [0]}, backend="ref", telemetry=True)
    assert sr_ref.telemetry[0].equals(
        run(SCN.with_seed(0), backend="ref", telemetry=True).telemetry)
    assert sr_ref.telemetry[0].num_windows > 0


def test_sweep_telemetry_raises_where_the_reference_raises():
    from repro_torch.scenario import BackendCapabilityError
    with pytest.raises(BackendCapabilityError, match="telemetry with faults"):
        sweep(SCN.replace(governor="ondemand"),
              axes={"faults": [(FaultSpec(0, 300.0),)]}, device="cpu",
              telemetry=True)


# ------------------------------------------------ artifacts

def test_telemetry_json_roundtrip_and_props():
    res = run(SCN.replace(governor="ondemand"), device="cpu", telemetry=True)
    tel = res.telemetry
    d = tel.to_dict()
    assert d["schema"] == TELEMETRY_SCHEMA == jtel.TELEMETRY_SCHEMA
    back = Telemetry.from_dict(json.loads(json.dumps(d)))
    assert back.equals(tel)
    # a file of either package loads in the other
    other = jtel.Telemetry.from_dict(json.loads(json.dumps(d)))
    np.testing.assert_array_equal(other.temps_c, tel.temps_c)
    theirs = jrun(JSCN.replace(governor="ondemand"), backend="ref",
                  telemetry=True).telemetry
    assert Telemetry.from_dict(theirs.to_dict()).num_windows \
        == theirs.num_windows
    with pytest.raises(ValueError, match="schema"):
        Telemetry.from_dict({"schema": "bogus"})
    assert np.all(np.diff(tel.time_us) > 0)
    assert tel.time_us[-1] == pytest.approx(tel.num_windows * tel.window_us)
    assert tel.peak_temp_c == float(np.max(tel.temps_c[:, :3]))
    assert tel.avg_power_w > 0.0


def test_chrome_trace_schema_valid_and_equals_the_references(tmp_path):
    scn, jscn = SCN.replace(governor="ondemand"), JSCN.replace(
        governor="ondemand")
    res = run(scn, backend="ref", telemetry=True)
    db = scn.soc()
    tr = chrome_trace(db, res.raw, apps=scn.applications(),
                      trace=scn.job_trace(), telemetry=res.telemetry)
    assert validate_chrome_trace(tr) == []
    events = tr["traceEvents"]
    names = [e for e in events if e["ph"] == "M" and e["name"] == "thread_name"]
    assert len(names) == db.num_pes
    n_b = sum(e["ph"] == "B" for e in events)
    n_e = sum(e["ph"] == "E" for e in events)
    assert n_b == n_e == len(res.raw.records)
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert counters == {"freq_ghz", "util", "temp_c"}
    assert any(e["name"].startswith("wifi_tx.") for e in events
               if e["ph"] == "B")
    path = tmp_path / "trace.json"
    write_chrome_trace(path, tr)
    assert validate_chrome_trace(json.loads(path.read_text())) == []
    jres = jrun(jscn, backend="ref", telemetry=True)
    want = jchrome_trace(jscn.soc(), jres.raw, apps=jscn.applications(),
                         trace=jscn.job_trace(), telemetry=jres.telemetry)
    assert tr == want
    # fail-stop markers on the dying PE's track
    faulted = run(SCN.replace(failures=(FaultSpec(0, 300.0),)), backend="ref")
    ftr = chrome_trace(db, faulted.raw, failures=faulted.scenario.failures)
    assert validate_chrome_trace(ftr) == []
    assert [e["tid"] for e in ftr["traceEvents"]
            if e["name"].startswith("FAIL-STOP")] == [0]


def test_chrome_trace_validator_catches_corruption():
    ok = {"traceEvents": [
        {"name": "t", "ph": "B", "pid": 0, "tid": 0, "ts": 1.0},
        {"name": "t", "ph": "E", "pid": 0, "tid": 0, "ts": 2.0}]}
    assert validate_chrome_trace(ok) == []
    assert validate_chrome_trace({}) == ["missing or non-list 'traceEvents'"]
    unmatched = {"traceEvents": ok["traceEvents"][:1]}
    assert any("unmatched 'B'" in e for e in validate_chrome_trace(unmatched))
    backwards = {"traceEvents": [
        {"name": "t", "ph": "B", "pid": 0, "tid": 0, "ts": 2.0},
        {"name": "t", "ph": "E", "pid": 0, "tid": 0, "ts": 1.0}]}
    errs = validate_chrome_trace(backwards)
    assert any("non-monotonic" in e for e in errs)
    assert any("precedes its 'B'" in e for e in errs)
    orphan_end = {"traceEvents": [
        {"name": "t", "ph": "E", "pid": 0, "tid": 0, "ts": 1.0}]}
    assert any("no open 'B'" in e for e in validate_chrome_trace(orphan_end))
    missing = {"traceEvents": [{"ph": "B", "pid": 0, "tid": 0, "ts": 0.0}]}
    assert any("missing key 'name'" in e
               for e in validate_chrome_trace(missing))


def test_bench_cli_json_payload(tmp_path, capsys):
    path = tmp_path / "BENCH_unit.json"
    seen = {}

    def run_fn(smoke, device):
        seen.update(smoke=smoke, device=device)
        return [("unit/x", 1.5, "note")]
    rc = bench_cli(run_fn, "unit", "doc",
                   ["--json", str(path), "--device", "cpu", "--smoke"])
    assert rc == 0 and seen == {"smoke": True, "device": torch.device("cpu")}
    out = capsys.readouterr().out
    assert "name,value,derived" in out and "unit/x,1.5000,note" in out
    payload = json.loads(path.read_text())
    assert payload["schema"] == BENCH_SCHEMA == "repro.obs/bench/v1"
    man = payload["manifest"]
    assert man["schema"] == MANIFEST_SCHEMA
    assert man["bench"] == "unit" and man["wall_s"] >= 0.0 and man["smoke"]
    assert man["device_platform"] == "cpu"
    assert payload["rows"] == [
        {"name": "unit/x", "value": 1.5, "derived": "note"}]
    again = rows_payload([("unit/x", 1.5, "note")], "unit", 0.0)
    assert again["rows"] == payload["rows"]
    assert bench_cli(lambda: [("a", 1.0, "")], "plain", argv=[
        "--device", "cpu", "--devices", "1"]) == 0
    with pytest.raises(ValueError, match="not ported"):
        bench_cli(run_fn, "unit", argv=["--device", "cpu", "--devices", "8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_cli(run_fn, "unit", argv=[])


def test_report_cli_trace_validate_render(tmp_path, capsys):
    trace_p = tmp_path / "TRACE.json"
    tel_p = tmp_path / "TELEMETRY.json"
    rc = report.main(["--jobs", "12", "--governor", "ondemand",
                      "--trace", str(trace_p), "--telemetry", str(tel_p)])
    assert rc == 0
    assert validate_chrome_trace(json.loads(trace_p.read_text())) == []
    assert json.loads(tel_p.read_text())["schema"] == TELEMETRY_SCHEMA
    assert report.main(["--validate", str(trace_p)]) == 0
    out = capsys.readouterr().out
    assert "valid Chrome trace" in out and "perfetto" in out
    # rendering: the port's bench payload, the reference's, a telemetry dump
    bench_p = tmp_path / "BENCH_unit.json"
    bench_p.write_text(json.dumps(rows_payload([("a/b", 2.0, "d")], "unit",
                                               0.1, device="cpu")))
    jbench_p = tmp_path / "BENCH_jax.json"
    jbench_p.write_text(json.dumps(jrows_payload([("c/d", 3.0, "e")], "jax",
                                                 0.2)))
    assert report.main([str(bench_p), str(jbench_p), str(tel_p)]) == 0
    out = capsys.readouterr().out
    assert "manifest:" in out and "rows (1):" in out and "windows" in out
    assert "device_platform    cpu" in out and "c/d" in out
    bad = tmp_path / "BAD.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "t", "ph": "B", "pid": 0, "tid": 0, "ts": 0.0}]}))
    assert report.main(["--validate", str(bad)]) == 1
    with pytest.raises(SystemExit):
        report.main(["--telemetry", str(tel_p)])
