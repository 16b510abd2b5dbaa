"""The dry-run's partitioned count (``repro_torch.launch.dryrun``:
``fake_world``, ``distribute``, ``CollectiveCounter``, ``collective_bytes``;
``repro_torch.sharding``'s restored ``shard``) against the JAX package's
arithmetic and XLA's partitioner, on the CPU.

What can be held equal, and is, exactly:

* the arithmetic: the events of ``tests/test_launch.py``'s ``HLO_SAMPLE``
  give the port's ``collective_bytes`` the reference's parse of that text;
* small programs where DTensor and XLA (the reference compiled for 8 forced
  CPU devices in a subprocess) are forced to the same collectives: a
  column-then-row sharded MLP (one all-reduce over ``model``), the gradient
  of a weight replicated over ``data`` (one all-reduce over ``data``), and a
  constraint from split to replicated over one axis and over both (one
  all-gather a split axis, ``model``'s first);
* a layout worked out by hand: reduced granite-3-8b's prefill on a (2, 4)
  mesh, every collective the rules imply, layer by layer.

What cannot: a model cell's counts.  XLA's partitioner picks other kinds
than DTensor's (an all-to-all or a collective-permute where DTensor
all-gathers, one all-reduce over both axes where DTensor issues two), and
its static HLO counts a scanned layer body once, while the port counts the
step's collectives at full depth.  Those cells are held to running, to the
reference's five keys, and to the same events on ``meta`` and on CPU
tensors.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as jax_roofline
from repro.launch.dryrun import collective_bytes as jax_collective_bytes
from repro_torch import sharding
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import LINK_BW
from repro_torch.sharding import Mesh, P, use_mesh

from hand_layouts import granite_prefill_by_hand

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH = Mesh((2, 4), ("data", "model"))
KINDS = ("prefill", "decode", "train")


def _overrides(arch):
    cfg = get_config(arch)
    r = reduced(cfg)
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
            if getattr(r, f.name) != getattr(cfg, f.name)}


def _cell(arch, kind, mesh_shape=(2, 4)):
    return dryrun.build_cell(arch, ShapeConfig(f"{kind}_s64", 64, 4, kind),
                             False, overrides=_overrides(arch),
                             mesh_shape=mesh_shape)


def _events(cell, args=None):
    events, _ = dryrun.count_collectives(
        cell.step, cell.args if args is None else args, cell.mesh,
        cell.rules, cell.arg_specs)
    return events


_CACHE = {}


def _cached_events(arch, kind):
    if (arch, kind) not in _CACHE:
        _CACHE[arch, kind] = _events(_cell(arch, kind))
    return _CACHE[arch, kind]


# ------------------------------------------ the mirror of the HLO parser test

def test_collective_bytes_equals_the_reference_parser():
    """``HLO_SAMPLE`` of tests/test_launch.py written out as (kind, result
    bytes, group) events: the sync and the async all-gather (the tuple's
    larger buffer, f32[1,128]) over groups of 16, bf16[4,256] all-reduced
    over 16, f32[2,64] reduce-scattered over 8, a bf16[8,8] permute."""
    from test_launch import HLO_SAMPLE
    events = [("all-gather", 128 * 4, 16), ("all-reduce", 4 * 256 * 2, 16),
              ("reduce-scatter", 2 * 64 * 4, 8),
              ("collective-permute", 8 * 8 * 2, 1),
              ("all-gather", 128 * 4, 16)]
    got = dryrun.collective_bytes(events)
    assert got == jax_collective_bytes(HLO_SAMPLE)
    assert tuple(got[0]) == dryrun.COLLECTIVES


# ------------------------------------------------ small programs against XLA

REF_PROGRAMS = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.dryrun import collective_bytes
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ns = lambda *s: NamedSharding(mesh, P(*s))
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    out = {}
    def run(name, fn, ins, args, outs):
        c = jax.jit(fn, in_shardings=ins, out_shardings=outs).lower(*args)
        out[name] = collective_bytes(c.compile().as_text())
    run("mlp", lambda x, w1, w2: (x @ w1) @ w2,
        (ns("data", None), ns(None, "model"), ns("model", None)),
        (sds(8, 16), sds(16, 32), sds(32, 16)), ns("data", None))
    run("grad", lambda w, x: jax.grad(lambda w: jnp.sum(x @ w))(w),
        (ns(), ns("data", None)), (sds(16, 16), sds(8, 16)), ns())
    gather = lambda x: jax.lax.with_sharding_constraint(x * 2, ns())
    run("gather", gather, (ns(None, "model"),), (sds(8, 16),), ns())
    run("gather2", gather, (ns("data", "model"),), (sds(8, 16),), ns())
    print("RESULT", json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_programs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_PROGRAMS], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT"))
    return json.loads(line[len("RESULT "):])


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _port_program(name):
    """The program ``name`` of ``REF_PROGRAMS`` as DTensors over a (2, 4)
    fake world; its outputs constrained as the reference's
    ``out_shardings`` are (``shard``, ``like_param``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = {"batch": "data", "model": "model"}
    with dryrun.fake_world(MESH) as dm, \
            use_mesh(MESH, rules, device_mesh=dm):
        if name == "mlp":
            vals, specs = (_meta(8, 16), _meta(16, 32), _meta(32, 16)), \
                (P("data"), P(None, "model"), P("model"))
        elif name == "grad":
            vals, specs = (_meta(16, 16), _meta(8, 16)), (P(), P("data"))
        else:
            vals = (_meta(8, 16),)
            specs = (P(None, "model") if name == "gather"
                     else P("data", "model"),)
        args = dryrun.distribute(vals, specs, dm, MESH)
        with dryrun.CollectiveCounter() as cc, implicit_replication():
            if name == "mlp":
                x, w1, w2 = args
                sharding.shard((x @ w1) @ w2, "batch", None)
            elif name == "grad":
                w, x = args
                w.requires_grad_()
                (g,) = torch.autograd.grad((x @ w).sum(), [w])
                sharding.like_param(g, w)
            else:
                sharding.shard(args[0] * 2, None, None)
    return cc.events


@pytest.mark.parametrize("name", ["mlp", "grad", "gather", "gather2"])
def test_small_programs_equal_xla(ref_programs, name):
    """Counts, result bytes and wire bytes by kind equal XLA's exactly: the
    MLP's partial sum all-reduced over ``model`` (f32[4,16]), the weight's
    gradient all-reduced over ``data`` (f32[16,16]), f32[8,16] gathered
    over ``model`` (and, split both ways, over ``model`` to f32[4,16] and
    then over ``data``)."""
    events = _port_program(name)
    got = dryrun.collective_bytes(events)
    assert [list(d.values()) for d in got] == \
        [list(ref_programs[name][i].values()) for i in range(3)]
    assert sum(got[2].values()) > 0
    groups = {"mlp": [4], "grad": [2], "gather": [4], "gather2": [4, 2]}
    assert [e.group for e in events] == groups[name]


# ------------------------------------------------- a layout worked by hand

def test_hand_derived_layout_of_granite_prefill():
    got = [tuple(e) for e in _cached_events("granite-3-8b", "prefill")]
    assert got == granite_prefill_by_hand()


# ---------------------------------------------------- every architecture runs

RUNS = [("gemma2-2b", "decode"), ("gemma2-2b", "train"),
        ("mamba2-130m", "decode"), ("mamba2-130m", "train"),
        ("granite-3-8b", "prefill"), ("deepseek-moe-16b", "prefill"),
        ("recurrentgemma-2b", "prefill"), ("paligemma-3b", "prefill"),
        ("starcoder2-7b", "train"), ("dbrx-132b", "decode"),
        ("seamless-m4t-large-v2", "decode"), ("mistral-nemo-12b", "decode")]


def test_the_runs_cover_every_architecture_and_kind():
    from repro_torch.configs import ARCHITECTURES
    assert {a for a, _ in RUNS} == set(ARCHITECTURES)
    for kind in KINDS:
        assert len({a for a, k in RUNS if k == kind}) >= 3, kind


@pytest.mark.parametrize("arch,kind", RUNS)
def test_every_architecture_runs_partitioned(arch, kind):
    """The reduced cell's step runs as DTensors on the (2, 4) fake world;
    every kind of the reference's five keys is counted: weights gathered
    over fsdp, partial sums all-reduced, and in training the gradients
    reduce-scattered to their parameters' layout."""
    res, wire, counts = dryrun.collective_bytes(_cached_events(arch, kind))
    assert tuple(counts) == dryrun.COLLECTIVES
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert counts["collective-permute"] == 0
    assert (counts["reduce-scatter"] > 0) >= (kind == "train")
    assert wire["all-reduce"] == 2 * res["all-reduce"]
    assert wire["all-gather"] == res["all-gather"]
    assert wire["reduce-scatter"] >= 2 * res["reduce-scatter"]
    assert not sharding.current_mesh() and not _dist_initialized()


def _dist_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


@pytest.mark.parametrize("arch,kind", [("granite-3-8b", "prefill"),
                                       ("mamba2-130m", "decode")])
def test_meta_and_cpu_tensors_give_the_same_events(arch, kind):
    cell = _cell(arch, kind)
    args = dryrun.real_args(cell, "cpu", seed=0)
    assert _events(cell, args) == _cached_events(arch, kind)


@pytest.mark.parametrize("arch,kind,same_bytes", [
    ("granite-3-8b", "prefill", True), ("mamba2-130m", "train", True),
    ("gemma2-2b", "decode", False)])
def test_one_device_world_is_the_plain_step(arch, kind, same_bytes):
    """On a (1, 1) mesh nothing is split: no collective, the same matmul
    FLOPs and, for prefill and train, the same bytes.  (A decode step's
    3-D @ 2-D products decompose into ``bmm`` on a ``DTensor`` and fold
    into ``mm`` on a plain tensor, which moves other bytes.)"""
    from torch.distributed.tensor.experimental import implicit_replication
    cell = _cell(arch, kind, mesh_shape=(1, 1))
    _, f0, b0 = dryrun.count_step(cell.step, cell.args)
    assert _events(cell) == []
    with dryrun.fake_world(cell.mesh) as dm, \
            use_mesh(cell.mesh, cell.rules, device_mesh=dm):
        dargs = dryrun.distribute(cell.args, cell.arg_specs, dm, cell.mesh)
        with implicit_replication():
            _, f1, b1 = dryrun.count_step(cell.step, dargs)
    assert f1 == f0 > 0
    assert (b1 == b0) is same_bytes


# ------------------------------------------------------- the fake world

def test_fake_world_cleans_up_and_refuses_a_second_group():
    import torch.distributed as dist
    assert not _dist_initialized()
    with dryrun.fake_world(MESH) as dm:
        assert dist.is_initialized() and dist.get_world_size() == 8
        assert dm.mesh_dim_names == ("data", "model")
        assert tuple(dm.shape) == (2, 4)
        with pytest.raises(RuntimeError, match="already exists"):
            with dryrun.fake_world(MESH):
                pass
    assert not _dist_initialized()
    with pytest.raises(ValueError, match="boom"):
        with dryrun.fake_world(Mesh((4,), ("model",))):
            raise ValueError("boom")
    assert not _dist_initialized()


def test_distribute_keeps_ceil_rows_of_an_uneven_split():
    """A dimension its axes do not divide: rank 0 holds ceil(d/k) rows, the
    block ``memory_analysis`` counts (``shard_shape``), and making it whole
    gathers the padded blocks, as XLA's all-gather of a padded split does."""
    from torch.distributed.tensor import Replicate
    spec = P("model", None)
    with dryrun.fake_world(MESH) as dm, use_mesh(MESH, {}, device_mesh=dm):
        (x,) = dryrun.distribute((_meta(6, 8),), (spec,), dm, MESH)
        assert tuple(x.shape) == (6, 8)
        assert tuple(x.to_local().shape) == sharding.shard_shape(
            (6, 8), spec, MESH) == (2, 8)
        with dryrun.CollectiveCounter() as cc:
            x.redistribute(dm, [Replicate(), Replicate()])
    assert cc.events == [("all-gather", 4 * 2 * 8 * 4, 4)]


def test_cpu_all_to_all_counts_as_one_all_to_all():
    """DTensor runs a resharding all-to-all as an all-gather and a chunk on
    a CPU mesh; the counter books one all-to-all of the chunk's bytes."""
    from torch.distributed.tensor import Shard
    mesh = Mesh((4,), ("model",))
    with dryrun.fake_world(mesh) as dm, use_mesh(mesh, {}, device_mesh=dm):
        (x,) = dryrun.distribute((_meta(8, 16),), (P("model"),), dm, mesh)
        with dryrun.CollectiveCounter() as cc:
            y = x.redistribute(dm, [Shard(1)])
    assert tuple(y.to_local().shape) == (8, 4)
    assert cc.events == [("all-to-all", 8 * 4 * 4, 4)]


def test_shard_is_the_identity_without_a_device_mesh():
    x = torch.ones(4, 8)
    with use_mesh(MESH, {"batch": "data", "model": "model"}):
        assert sharding.shard(x, "batch", "model") is x
        assert sharding.reshape(x, (4, 2, 4)).shape == (4, 2, 4)
        assert not sharding.is_split(x, 0)
        assert sharding.like_param(x, x) is x and sharding.pinned(x) is x
    assert sharding.placements(P(("data", "model")), MESH)[0].dim == 0
    with pytest.raises(ValueError, match="order"):
        sharding.placements(P(("model", "data")), MESH)


# ------------------------------------------------------------- roofline

def test_roofline_collective_term_is_the_references_arithmetic():
    """The same record dict: the port's t_collective × LINK_BW equals the
    reference's t_collective × ICI_BW (both: the summed wire bytes)."""
    _, wire, _ = dryrun.collective_bytes(_cached_events("granite-3-8b",
                                                        "prefill"))
    rec = {"runnable": True, "arch": "granite-3-8b", "shape": "prefill_32k",
           "num_devices": 8, "memory_analysis": {},
           "extrapolated": {"flops": 1e12, "bytes": 1e9, "wire": wire}}
    t = roofline.cell_terms(rec)
    j = jax_roofline.cell_terms(rec)
    assert t["t_collective"] * LINK_BW == pytest.approx(
        j["t_collective"] * jax_roofline.ICI_BW, rel=1e-12)
    assert t["t_collective"] * LINK_BW == pytest.approx(sum(wire.values()),
                                                        rel=1e-12)
    assert LINK_BW == 450e9


def test_the_port_imports_without_dtensor():
    """Every module of the port imports without ``torch.distributed.tensor``
    (DTensor is imported inside the functions that need a device mesh)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        print("DTENSOR", "torch.distributed.tensor" in sys.modules)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DTENSOR False" in proc.stdout
