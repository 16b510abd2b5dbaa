"""``repro_torch.scenario.shardexec`` — the sharded and chunked lane
executor — on the CPU: the cases of tests/test_shardexec.py and
tests/test_faults_jax.py::test_fault_sweep_composes_with_chunk_and_design_axis.

``sweep(..., chunk=N)`` and ``sweep(..., shard=...)`` over virtual lane
devices (``sharding.virtual_lane_devices``: the CPU N times, in process,
where the reference forces N XLA host devices in a subprocess) equal the
plain sweep bit for bit on every output (static, DTPM streaming designs,
DTPM streaming policies, faults, telemetry), with the device, chunk and pad
counters counted as the reference counts them; against the JAX package the
tolerances of tests/test_torch_sweep.py (makespan exact, sums 1e-6
relative, peak temperature 1e-5).  On the CPU the blocks run one after
another: the streams of a card are the card test's
(tests/test_torch_card.py).
"""
import contextlib
import dataclasses
import importlib
import json

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
from repro_torch import sharding
from repro_torch.obs import bench_cli
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


# ------------------------------------------------ lane sharding (virtual devices)

def _sharded(scn, axes, devices, pads, **kw):
    """sweep(...) under ``devices`` virtual CPU lane devices (auto-sharded
    unless ``kw`` says otherwise), asserting the mesh width and the pad
    lanes it added."""
    _, p0 = _counts()
    with sharding.virtual_lane_devices(devices):
        out = sweep(scn, axes=axes, device="cpu", **kw)
    assert metrics.counter("scenario.shard.devices").value == devices
    assert _counts()[1] - p0 == pads
    return out


def _tel_equal(a, b):
    _assert_bitexact(a, b)
    assert a.telemetry.shape == b.telemetry.shape == a.shape
    assert all(x.equals(y) for x, y in zip(a.telemetry.flat, b.telemetry.flat))


def test_sharded_sweep_bitexact_8_virtual_devices():
    """The twin of the reference's 8-device test: 5 designs x 2 seeds over 8
    virtual lane devices — auto-shard = ``shard=False`` bit for bit (devices
    8, 3 pad lanes), ``shard=True, chunk=2``, telemetry, the ondemand
    policy-lane axis — and the JAX package's sweep within the sweep
    tolerances."""
    axes = {"design": POINTS, "seed": [0, 1]}
    plain = sweep(SCN, axes=axes, device="cpu", shard=False)
    n0 = sum(sweep_mod.scan_calls.values())
    _assert_bitexact(plain, _sharded(SCN, axes, 8, pads=3))
    assert sum(sweep_mod.scan_calls.values()) - n0 == 8       # a scan a block
    # sharding composes with chunking (chunk=2 -> width 8 a chunk)
    c0, _ = _counts()
    _assert_bitexact(plain, _sharded(SCN, axes, 8, pads=3, shard=True,
                                     chunk=2))
    assert _counts()[0] - c0 == 1                   # chunks, not blocks
    # telemetry replays block by block, equal to the unsharded replay
    _tel_equal(sweep(SCN, axes=axes, device="cpu", shard=False,
                     telemetry=True),
               _sharded(SCN, axes, 8, pads=3, shard=True, telemetry=True))
    # the DTPM policy-lane axis shards too
    scn = SCN.replace(governor="ondemand")
    paxes = {"governor_params": [(("up_threshold", 0.5 + 0.08 * i),)
                                 for i in range(5)], "seed": [0]}
    _assert_bitexact(sweep(scn, axes=paxes, device="cpu", shard=False),
                     _sharded(scn, paxes, 8, pads=3))
    want = jsweep(JSCN, axes={"design": [jdse.DesignPoint(
        cross_cluster_penalty=p.cross_cluster_penalty) for p in POINTS],
        "seed": [0, 1]})
    np.testing.assert_array_equal(plain.makespan_us, want.makespan_us)
    np.testing.assert_allclose(plain.energy_j, want.energy_j, rtol=1e-6)
    np.testing.assert_allclose(plain.peak_temp_c, want.peak_temp_c,
                               rtol=1e-5)


FAULT_SETS = [(), (FaultSpec(0, 200.0),), (FaultSpec(1, 100.0),
                                          FaultSpec(2, 300.0))]
ONDEMAND = [(("up_threshold", u),) for u in (0.55, 0.6, 0.7, 0.8, 0.9)]

# (name, governor, axes, lanes streamed): static designs, DTPM streaming
# designs (D >= G) and policies (G > D), and the fault grids, whose streamed
# axis sits at position 1 (static; DTPM designs) or 2 (DTPM policies)
SHARD_CASES = [
    ("static", "design", {"design": POINTS, "rate": [10.0, 40.0]}, 5),
    ("dtpm-designs", "ondemand", {"design": POINTS[:3],
                                  "governor_params": ONDEMAND[:2],
                                  "seed": [0]}, 3),
    ("dtpm-policies", "ondemand", {"design": POINTS[:2],
                                   "governor_params": ONDEMAND,
                                   "seed": [0, 1]}, 5),
    ("faults-static", "design", {"faults": FAULT_SETS, "design": POINTS[:3],
                                 "seed": [0, 1]}, 3),
    ("faults-dtpm-designs", "ondemand", {"faults": FAULT_SETS,
                                         "design": POINTS[:3],
                                         "governor_params": ONDEMAND[:1],
                                         "seed": [0]}, 3),
    ("faults-dtpm-policies", "ondemand", {"faults": FAULT_SETS[:2],
                                          "governor_params": ONDEMAND[:3],
                                          "seed": [0]}, 3),
]


@pytest.mark.parametrize("devices,chunk", [(2, None), (4, None), (3, 2)])
@pytest.mark.parametrize("name,governor,axes,lanes", SHARD_CASES,
                         ids=[c[0] for c in SHARD_CASES])
def test_sharded_grids_bitexact(name, governor, axes, lanes, devices, chunk):
    """Every grid kind over 2, 3 and 4 virtual lane devices, alone and with
    ``chunk=``: equal to the unsharded sweep bit for bit, a scan a block,
    the pad lanes counted as the reference counts them."""
    scn = SCN.replace(governor=governor)
    plain = sweep(scn, axes=axes, device="cpu")
    width = shardexec.padded_width(lanes, chunk, devices)
    n_chunks = -(-lanes // width)
    c0, _ = _counts()
    n0 = sum(sweep_mod.scan_calls.values())
    got = _sharded(scn, axes, devices, pads=n_chunks * width - lanes,
                   chunk=chunk)
    _assert_bitexact(plain, got)
    assert _counts()[0] - c0 == (n_chunks if chunk else 1)
    assert sum(sweep_mod.scan_calls.values()) - n0 == n_chunks * devices


@pytest.mark.parametrize("governor,axes,pads", [
    ("design", {"design": POINTS[:3], "seed": [0]}, 1),
    ("ondemand", {"governor_params": ONDEMAND[:3], "seed": [0, 1]}, 1),
    ("ondemand", {"design": POINTS[:3], "governor_params": ONDEMAND[:2],
                  "seed": [0]}, 1),
    ("design", {"faults": FAULT_SETS[:2], "design": POINTS[:2],
                "seed": [0]}, 0),
], ids=["static", "dtpm-policies", "dtpm-designs", "faults-static"])
def test_sharded_telemetry_bitexact(governor, axes, pads):
    """Each block's lanes are replayed on its device right after its launch:
    the timelines equal the unsharded sweep's bit for bit (2 virtual
    devices: a pad lane in every grid but the fault grid)."""
    scn = SCN.replace(governor=governor)
    _tel_equal(sweep(scn, axes=axes, device="cpu", telemetry=True),
               _sharded(scn, axes, 2, pads=pads, telemetry=True))


def test_sharded_policy_block_equals_the_wider_grid():
    """A lane's bits do not depend on the other designs of its launch: 2
    designs x 5 policies over 8 virtual devices (policies stream), padded to
    the PE width of a 5-design grid, equal that grid's first 2 designs bit
    for bit."""
    scn = SCN.replace(governor="ondemand")
    wide = {"design": POINTS[:1] + [dataclasses.replace(
        SCN.design, num_little=SCN.design.num_little + 2)] + POINTS[1:4],
        "governor_params": ONDEMAND, "seed": [0]}
    full = sweep(scn, axes=wide, device="cpu")
    pad = int(tables_for(scn.replace(design=wide["design"][1]),
                         device="cpu").num_pes)
    part = dict(wide, design=wide["design"][:2])
    got = _sharded(scn, part, 8, pads=3, pad_pes=pad)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(full, f)[:2]), f


def test_evaluate_sharded_equals_plain():
    """``evaluate(shard=True)`` over 4 virtual lane devices (and with
    ``chunk=``, and under an ondemand governor) equals the plain call."""
    pts = DesignSpace().sample_lhs(7, seed=4)
    traces = [poisson_trace(20.0, 12, ["wifi_tx"], seed=s) for s in (0, 1)]
    for kw in ({}, {"governor": "ondemand"}):
        plain = evaluate(pts, [wifi_tx()], traces, device="cpu", **kw)
        for chunk, pads in ((None, 1), (3, 1)):
            _, p0 = _counts()
            with sharding.virtual_lane_devices(4):
                got = evaluate(pts, [wifi_tx()], traces, device="cpu",
                               shard=True, chunk=chunk, **kw)
            assert metrics.counter("scenario.shard.devices").value == 4
            assert _counts()[1] - p0 == pads
            np.testing.assert_array_equal(got.objectives(),
                                          plain.objectives())
            np.testing.assert_array_equal(got.latency_per_trace_us,
                                          plain.latency_per_trace_us)
            np.testing.assert_array_equal(got.temp_per_trace_c,
                                          plain.temp_per_trace_c)


@pytest.mark.parametrize("virtual", [None, 1, 2, 8])
def test_resolve_mesh_with_and_without_virtual_devices(virtual):
    """``False`` never shards; ``None`` and ``True`` shard exactly when
    there is more than one lane device; the mesh keeps its devices."""
    cpu = torch.device("cpu")
    ctx = (sharding.virtual_lane_devices(virtual) if virtual
           else contextlib.nullcontext())
    with ctx:
        devices = sharding.lane_devices("cpu")
        assert devices == (cpu,) * (virtual or 1)
        assert shardexec.resolve_mesh(False, devices) is None
        for shard in (None, True):
            mesh = shardexec.resolve_mesh(shard, devices)
            if (virtual or 1) == 1:
                assert mesh is None
            else:
                assert mesh.devices == devices
                assert sharding.lane_count(mesh) == virtual
                assert mesh.shape == {sharding.LANE_AXIS: virtual}
        if (virtual or 1) > 1:          # the default devices: the CPU's here
            assert shardexec.resolve_mesh(False) is None
        # shard=False under virtual devices streams nothing
        c0 = _counts()
        sweep(SCN, axes={"seed": [0, 1]}, device="cpu", shard=False)
        assert _counts() == c0
    assert sharding.lane_devices("cpu") == (cpu,)


@pytest.mark.parametrize("devices", [
    [torch.device("cpu")], [torch.device("cuda", 0)], ["cpu"], []],
    ids=["cpu", "cuda0", "name", "none"])
def test_lane_mesh_of_one_device_is_none(devices):
    assert sharding.lane_mesh(devices) is None
    assert sharding.lane_count(sharding.lane_mesh(devices)) == 1


def test_lane_mesh_refusals():
    with pytest.raises(ValueError, match="one kind of device"):
        sharding.lane_mesh([torch.device("cpu"), torch.device("cuda", 0)])
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError, match="positive count"):
            with sharding.virtual_lane_devices(bad):
                pass
    with pytest.raises(ValueError, match="2 devices"):
        sharding.Mesh((4,), (sharding.LANE_AXIS,),
                      devices=(torch.device("cpu"),) * 2)
    # nested settings restore the outer one
    with sharding.virtual_lane_devices(4):
        with sharding.virtual_lane_devices(2):
            assert len(sharding.lane_devices("cpu")) == 2
        assert len(sharding.lane_devices("cpu")) == 4


def test_bench_cli_devices_runs_sharded(tmp_path, capsys):
    """``bench_cli --devices 4 --device cpu``: the benchmark runs under 4
    virtual lane devices (its sweep auto-shards over them) and the manifest
    records 4."""
    path = tmp_path / "BENCH_lanes.json"
    axes = {"design": POINTS, "seed": [0]}
    plain = sweep(SCN, axes=axes, device="cpu")
    got = {}

    def run_fn(device):
        got["sr"] = sweep(SCN, axes=axes, device=device)
        return [("lanes/points", float(got["sr"].num_points), "")]

    assert bench_cli(run_fn, "lanes", argv=["--devices", "4", "--device",
                                            "cpu", "--json", str(path)]) == 0
    assert metrics.counter("scenario.shard.devices").value == 4
    _assert_bitexact(plain, got["sr"])
    man = json.loads(path.read_text())["manifest"]
    assert man["lane_devices"] == 4 and man["device_platform"] == "cpu"
    assert "lanes/points,5.0000" in capsys.readouterr().out
