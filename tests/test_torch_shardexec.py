"""``repro_torch.scenario.shardexec`` — the chunked lane executor — on the
CPU: the cases of tests/test_shardexec.py and
tests/test_faults_jax.py::test_fault_sweep_composes_with_chunk_and_design_axis.

``sweep(..., chunk=N)`` equals the plain sweep bit for bit on every output
(static, DTPM streaming designs, DTPM streaming policies, faults), with the
chunk and pad counters counted as the reference counts them; against the
JAX package the tolerances of tests/test_torch_sweep.py (makespan exact,
sums 1e-6 relative, peak temperature 1e-5).

One reference test has no twin here:
``test_sharded_sweep_bitexact_8_virtual_devices`` has none on one card
(lane sharding is not ported; ``resolve_mesh`` resolves every ``shard`` to
the one device).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.dse as jdse
from repro.scenario import FaultSpec as JFaultSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import TraceSpec as JTraceSpec
from repro.scenario import run as jrun
from repro.scenario import sweep as jsweep
from repro_torch.core.dvfs import stack_policies
from repro_torch.core.simkernel_torch import ARRAY_FIELDS
from repro_torch.dse import (DesignPoint, DesignSpace, build_design_batch,
                             evaluate, stack_tables)
from repro_torch.obs import metrics
from repro_torch.scenario import (BackendCapabilityError, FaultSpec, Scenario,
                                  TraceSpec, sweep, tables_for)
from repro_torch.scenario import shardexec
from repro_torch.core.applications import wifi_tx
from repro_torch.core.jobgen import poisson_trace

# the module (the package's `sweep` attribute is the function)
sweep_mod = importlib.import_module("repro_torch.scenario.sweep")

torch.set_num_threads(1)

SPEC = dict(apps=("wifi_tx",), scheduler="etf", governor="design")
TRACE = dict(rate_jobs_per_ms=25.0, num_jobs=16, seed=3)
SCN = Scenario(trace=TraceSpec(**TRACE), **SPEC)
JSCN = JScenario(trace=JTraceSpec(**TRACE), **SPEC)
POINTS = [DesignPoint(cross_cluster_penalty=1.0 + 0.5 * i) for i in range(5)]
FIELDS = ("avg_latency_us", "makespan_us", "energy_j", "peak_temp_c",
          "busy_per_pe_us")


def _assert_bitexact(a, b):
    assert a.shape == b.shape
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _counts():
    return (metrics.counter("scenario.sweep.chunks").value,
            metrics.counter("scenario.shard.pad_lanes").value)


def _chunked(scn, axes, chunk, chunks, pads):
    """sweep(chunk=) on the CPU, asserting the chunks and pad lanes it
    streamed."""
    c0, p0 = _counts()
    out = sweep(scn, axes=axes, device="cpu", chunk=chunk)
    assert _counts() == (c0 + chunks, p0 + pads)
    assert metrics.counter("scenario.shard.devices").value == 1
    return out


# ------------------------------------------------ pad/width helpers

def test_padded_width_is_pinned():
    assert shardexec.padded_width(5, None, 1) == 5
    assert shardexec.padded_width(5, None, 8) == 8
    # chunk given: the width is chunk-derived, not lane-derived
    assert shardexec.padded_width(5, 2, 1) == 2
    assert shardexec.padded_width(3, 2, 1) == 2
    assert shardexec.padded_width(5, 3, 2) == 4
    assert shardexec.padded_width(100, 8, 8) == 8


def test_pad_lane_axis_repeats_lane0():
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.arange(3)}
    out = shardexec.pad_lane_axis(tree, 3, 5)
    assert out["a"].shape == (5, 2) and out["b"].shape == (5,)
    assert torch.equal(out["a"][3], tree["a"][0])
    assert torch.equal(out["a"][4], tree["a"][0])
    assert torch.equal(out["a"][:3], tree["a"])
    # width == lanes is the identity (same object, no copy)
    assert shardexec.pad_lane_axis(tree, 3, 3) is tree
    # on another axis, and through a table stack and a policy stack
    assert torch.equal(shardexec.pad_lane_axis(tree["a"], 2, 4, axis=1),
                       tree["a"][:, [0, 1, 0, 0]])
    tb = stack_tables([tables_for(SCN.replace(design=p), pad_pes=SCN.design.num_pes,
                                  device="cpu") for p in POINTS[:2]])
    padded = shardexec.pad_lane_axis(tb, 2, 3)
    for name in ARRAY_FIELDS:
        if getattr(tb, name) is not None:
            assert torch.equal(getattr(padded, name)[2], getattr(tb, name)[0])
    assert (padded.t_max, padded.num_pes) == (tb.t_max, tb.num_pes)
    pols = stack_policies([SCN.replace(
        governor="ondemand", governor_params=(("up_threshold", u),))
        .make_policy() for u in (0.6, 0.9)])
    padded = shardexec.pad_lane_axis(pols, 2, 4)
    assert padded.lanes == 4 and torch.equal(padded.up[2:], pols.up[[0, 0]])


def test_host_stacks_stay_on_the_cpu():
    tables = [tables_for(SCN.replace(design=p), pad_pes=SCN.design.num_pes, device="cpu")
              for p in POINTS[:3]]
    host = stack_tables(tables, host=True, device="cpu")
    dev = stack_tables(tables, device="cpu")
    assert host.device == torch.device("cpu")
    for name in ARRAY_FIELDS:
        if getattr(dev, name) is not None:
            x = getattr(host, name)
            assert x.device.type == "cpu" and torch.equal(x, getattr(dev, name))
    tb, nodes = sweep_mod._design_lanes(SCN, ["design"], [(p,) for p in POINTS],
                                        None, torch.device("cpu"), host=True)
    assert tb.device.type == "cpu" and nodes.shape == (5, SCN.design.num_pes)
    assert shardexec.host_tables(tb, torch.device("cpu")) is tb


# ------------------------------------------------ chunked == plain

def test_chunked_static_sweep_bitexact():
    """chunk=2 over 5 uneven design lanes: equal to the plain sweep, with
    the streaming counters accounting for every chunk and pad lane, and to
    the JAX package's chunked sweep within the sweep tolerances."""
    axes = {"design": POINTS, "seed": [0, 1]}
    plain = sweep(SCN, axes=axes, device="cpu")
    chunked = _chunked(SCN, axes, 2, chunks=3, pads=1)
    _assert_bitexact(plain, chunked)
    want = jsweep(JSCN, axes={"design": [jdse.DesignPoint(
        cross_cluster_penalty=p.cross_cluster_penalty) for p in POINTS],
        "seed": [0, 1]}, chunk=2)
    np.testing.assert_array_equal(chunked.makespan_us, want.makespan_us)
    np.testing.assert_allclose(chunked.energy_j, want.energy_j, rtol=1e-6)
    np.testing.assert_allclose(chunked.peak_temp_c, want.peak_temp_c,
                               rtol=1e-5)
    # one chunk as wide as the grid, and chunks wider than it
    _assert_bitexact(plain, _chunked(SCN, axes, 5, chunks=1, pads=0))
    _assert_bitexact(plain, _chunked(SCN, axes, 8, chunks=1, pads=3))


def test_chunked_dtpm_sweep_bitexact_both_lane_axes():
    """The DTPM grid streams whichever lane axis is wider: the policy axis
    (G > D) and the design axis (D >= G) both chunk clean."""
    scn = SCN.replace(governor="ondemand")
    params = [(("up_threshold", 0.5 + 0.08 * i),) for i in range(5)]
    # G=5 > D=1: policy lanes stream
    axes = {"governor_params": params, "seed": [0, 1]}
    _assert_bitexact(sweep(scn, axes=axes, device="cpu"),
                     _chunked(scn, axes, 2, chunks=3, pads=1))
    # D=3 > G=2: design lanes stream
    axes = {"design": POINTS[:3], "governor_params": params[:2],
            "seed": [0]}
    _assert_bitexact(sweep(scn, axes=axes, device="cpu"),
                     _chunked(scn, axes, 2, chunks=2, pads=1))


def test_chunked_fault_sweeps_bitexact_static_and_dtpm():
    """Fault lanes: the design axis streams at position 1 (static) and the
    policy axis at position 2 (DTPM, G > D)."""
    fs = [(), (FaultSpec(0, 200.0),), (FaultSpec(1, 100.0),
                                       FaultSpec(2, 300.0))]
    axes = {"faults": fs, "design": POINTS[:3], "seed": [0, 1]}
    _assert_bitexact(sweep(SCN, axes=axes, device="cpu"),
                     _chunked(SCN, axes, 2, chunks=2, pads=1))
    scn = SCN.replace(governor="ondemand")
    axes = {"faults": fs, "governor_params": [
        (("up_threshold", u),) for u in (0.6, 0.7, 0.9)], "seed": [0]}
    _assert_bitexact(sweep(scn, axes=axes, device="cpu"),
                     _chunked(scn, axes, 2, chunks=2, pads=1))


def test_chunked_telemetry_replay_bitexact():
    """Each chunk's lanes are replayed after its launch: the timelines equal
    the unchunked sweep's bit for bit, static (designs streamed, a pad
    design), DTPM streaming policies (a pad policy) and designs, and static
    fault lanes."""
    def tel_equal(a, b):
        _assert_bitexact(a, b)
        assert a.telemetry.shape == b.telemetry.shape == a.shape
        assert all(x.equals(y) for x, y in zip(a.telemetry.flat,
                                               b.telemetry.flat))

    axes = {"design": POINTS[:3], "seed": [0]}
    tel_equal(sweep(SCN, axes=axes, device="cpu", telemetry=True),
              _chunked_tel(SCN, axes, 2, chunks=2, pads=1))
    scn = SCN.replace(governor="ondemand")
    axes = {"governor_params": [(("up_threshold", 0.6),),
                                (("up_threshold", 0.8),),
                                (("up_threshold", 0.9),)], "seed": [0]}
    tel_equal(sweep(scn, axes=axes, device="cpu", telemetry=True),
              _chunked_tel(scn, axes, 2, chunks=2, pads=1))
    axes = {"design": POINTS[:3], "governor_params": axes["governor_params"][:2],
            "seed": [0, 1]}
    tel_equal(sweep(scn, axes=axes, device="cpu", telemetry=True),
              _chunked_tel(scn, axes, 2, chunks=2, pads=1))
    axes = {"faults": [(), (FaultSpec(0, 300.0),)], "design": POINTS[:2],
            "seed": [0]}
    tel_equal(sweep(SCN, axes=axes, device="cpu", telemetry=True),
              _chunked_tel(SCN, axes, 1, chunks=2, pads=0))


def _chunked_tel(scn, axes, chunk, chunks, pads):
    c0, p0 = _counts()
    out = sweep(scn, axes=axes, device="cpu", chunk=chunk, telemetry=True)
    assert _counts() == (c0 + chunks, p0 + pads)
    return out


def test_fault_sweep_composes_with_chunk_and_design_axis():
    d0 = SCN.design
    d1 = dataclasses.replace(d0, num_little=d0.num_little + 2)
    fl = [(), (FaultSpec(0, 500.0),)]
    jfl = [(), (JFaultSpec(0, 500.0),)]
    axes = {"design": [d0, d1], "faults": fl, "rate": [10.0]}
    base = sweep(SCN, axes=axes, device="cpu")
    chunked = _chunked(SCN, axes, 1, chunks=2, pads=0)
    np.testing.assert_array_equal(base.makespan_us, chunked.makespan_us)
    np.testing.assert_array_equal(base.energy_j, chunked.energy_j)
    jd1 = dataclasses.replace(JSCN.design, num_little=d0.num_little + 2)
    r = jrun(JSCN.at_rate(10.0).replace(design=jd1, failures=jfl[1]),
             backend="jax")
    assert np.float32(chunked.makespan_us[1, 1, 0]) == np.float32(r.makespan_us)


def test_every_chunk_launches_at_the_pinned_width(monkeypatch):
    """Every chunk's scan gets the same lane count (pad lanes included),
    whatever the grid's design count: one table shape a chunk width."""
    widths = []
    grid = sweep_mod.simulate_grid

    def record(tables, *args, **kw):
        widths.append(int(tables.exec_us.shape[0]))
        return grid(tables, *args, **kw)

    monkeypatch.setattr(sweep_mod, "simulate_grid", record)
    n0 = sum(sweep_mod.scan_calls.values())
    sweep(SCN, axes={"design": POINTS, "seed": [0]}, device="cpu", chunk=2)
    sweep(SCN, axes={"design": POINTS[:3], "seed": [0]}, device="cpu",
          chunk=2)
    assert widths == [2] * 5
    assert sum(sweep_mod.scan_calls.values()) - n0 == 5   # a scan a chunk


def test_evaluate_chunked_equals_plain():
    pts = DesignSpace().sample_lhs(7, seed=4)
    traces = [poisson_trace(20.0, 12, ["wifi_tx"], seed=s) for s in (0, 1)]
    plain = evaluate(pts, [wifi_tx()], traces, device="cpu")
    c0, p0 = _counts()
    got = evaluate(pts, [wifi_tx()], traces, device="cpu", chunk=3,
                   shard=True)
    assert _counts() == (c0 + 3, p0 + 2)
    np.testing.assert_array_equal(got.objectives(), plain.objectives())
    np.testing.assert_array_equal(got.latency_per_trace_us,
                                  plain.latency_per_trace_us)
    # a prebuilt batch streams too
    batch = build_design_batch(pts, [wifi_tx()], device="cpu")
    got = evaluate(pts, [wifi_tx()], traces, batch=batch, device="cpu",
                   chunk=4)
    np.testing.assert_array_equal(got.objectives(), plain.objectives())


# ------------------------------------------------ argument validation

def test_chunk_validation():
    axes = {"design": POINTS[:2], "seed": [0]}
    with pytest.raises(ValueError, match="positive lane count"):
        sweep(SCN, axes=axes, device="cpu", chunk=0)
    with pytest.raises(ValueError, match="positive lane count"):
        sweep(SCN, axes=axes, device="cpu", chunk=2.5)
    with pytest.raises(BackendCapabilityError, match="lane options"):
        sweep(SCN, axes={"seed": [0]}, backend="ref", chunk=2)
    with pytest.raises(BackendCapabilityError, match="lane options"):
        sweep(SCN, axes={"seed": [0]}, backend="ref", shard=True)


def test_resolve_mesh_single_device():
    # one device: no mesh — the chunked path runs unsharded
    assert shardexec.resolve_mesh(None) is None
    assert shardexec.resolve_mesh(True) is None
    assert shardexec.resolve_mesh(False) is None
    # shard alone leaves the grid unstreamed: no chunk counted
    c0 = _counts()
    _assert_bitexact(sweep(SCN, axes={"seed": [0, 1]}, device="cpu"),
                     sweep(SCN, axes={"seed": [0, 1]}, device="cpu",
                           shard=True))
    assert _counts() == c0
