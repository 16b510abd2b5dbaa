"""The port's layouts and launch tools (``repro_torch.sharding``,
``launch/mesh``, ``specs``, ``dryrun``, ``roofline``, ``hillclimb``, the
autotune example) against the JAX package's, on the CPU.

Mirrors all six tests of tests/test_launch.py (the sixth, the collective
parser's, as ``test_collective_bytes_equals_the_reference_parser`` in
tests/test_torch_collectives.py, with the rest of the partitioned count) and
adds:
rules, parameter axes and specs, batch and cache specs, the analytic FLOPs
and the hillclimb cells equal to the reference's exactly; the dry-run's
per-device argument and output bytes equal to ``memory_analysis()`` of the
reference's compiled (2,4) cells (computed in a forced-8-device
subprocess), exactly; ``meta`` FLOPs and bytes equal to the same step's on
CPU tensors, exactly; the example's simulated steps equal to the reference
simulator's on the same per-layer costs within 1e-6 relative.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import hillclimb as jax_hillclimb
from repro.launch import roofline as jax_roofline
from repro.launch.mesh import rules_for as jax_rules_for
from repro.launch.specs import batch_specs as jax_batch_specs
from repro.launch.specs import cache_specs as jax_cache_specs
from repro.models import build_model as jax_build_model
from repro.sharding import use_mesh as jax_use_mesh
from repro_torch import sharding
from repro_torch.configs import (ARCHITECTURES, SHAPES, ShapeConfig,
                                 cell_is_runnable, get_config, get_shape,
                                 reduced)
from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.launch.roofline import _matmul_params, model_flops
from repro_torch.launch.specs import batch_specs, cache_specs
from repro_torch.models import build_model
from repro_torch.sharding import (Mesh, P, logical_to_pspec, rules_multi_pod,
                                  rules_single_pod, use_mesh)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [Mesh((16, 16), ("data", "model")),
          Mesh((2, 16, 16), ("pod", "data", "model")),
          Mesh((1, 1), ("data", "model")), Mesh((2, 4), ("data", "model"))]
KINDS = ("train", "prefill", "decode", "train_pp")
TDT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16, "int8": torch.int8}


def _spec(ps):
    """A jax PartitionSpec or the port's P as a plain tuple."""
    return tuple(ps)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key],
                                                       path + (key,)).items()}
    return {path: tree}


def _reduced_overrides(arch):
    cfg = get_config(arch)
    r = reduced(cfg)
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
            if getattr(r, f.name) != getattr(cfg, f.name)}


# ------------------------------------------- mirrors of tests/test_launch.py

def test_rules_and_pspecs():
    r = rules_single_pod()
    assert r["batch"] == "data" and r["model"] == "model"
    rm = rules_multi_pod()
    assert rm["batch"] == ("pod", "data")


def test_cell_skips_match_design():
    runnable = {(a, s): cell_is_runnable(get_config(a), get_shape(s))[0]
                for a in ARCHITECTURES for s in SHAPES}
    assert runnable[("mamba2-130m", "long_500k")]
    assert runnable[("recurrentgemma-2b", "long_500k")]
    for a in ["gemma2-2b", "dbrx-132b", "granite-3-8b", "paligemma-3b",
              "seamless-m4t-large-v2", "starcoder2-7b", "mistral-nemo-12b",
              "deepseek-moe-16b"]:
        assert not runnable[(a, "long_500k")], a
    for a in ARCHITECTURES:
        for s in ["train_4k", "prefill_32k", "decode_32k"]:
            assert runnable[(a, s)], (a, s)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_batch_specs_cover_all_inputs(arch):
    cfg = get_config(arch)
    for shape_name in ["train_4k", "decode_32k"]:
        shape = get_shape(shape_name)
        sds, ps = batch_specs(cfg, shape)
        assert set(sds) == set(ps)
        assert sds["tokens"].dtype == torch.int32
        assert all(t.device.type == "meta" for t in sds.values())
        if shape.kind == "train":
            assert "labels" in sds
            if cfg.frontend == "vision":
                assert sds["patch_embeds"].shape[1] == cfg.num_prefix_tokens
                assert (sds["tokens"].shape[1]
                        == shape.seq_len - cfg.num_prefix_tokens)
            elif cfg.frontend == "audio":
                assert tuple(sds["frames"].shape) == (
                    shape.global_batch, shape.seq_len, cfg.d_model)
        else:
            assert tuple(sds["tokens"].shape) == (shape.global_batch, 1)


def test_model_flops_sane():
    f = model_flops("granite-3-8b", "train_4k")
    tokens = 256 * 4096
    n_active = sum(_matmul_params(get_config("granite-3-8b")).values())
    assert 7e9 < n_active < 9e9
    assert f > 6 * n_active * tokens
    assert f < 6 * n_active * tokens * 1.6
    n_moe = sum(_matmul_params(get_config("deepseek-moe-16b")).values())
    assert n_moe < 5e9
    fd = model_flops("granite-3-8b", "decode_32k")
    assert fd < f / 1000


def test_long500k_shapes_divisible_for_kv_seq_sharding():
    for arch in ["mamba2-130m", "recurrentgemma-2b"]:
        cfg = get_config(arch)
        s = get_shape("long_500k")
        assert s.seq_len % 16 == 0
        if cfg.window_size:
            assert cfg.window_size % 16 == 0


# ------------------------------------------------ equal to the reference

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m.axis_sizes)))
def test_rules_for_equal_the_reference(mesh):
    """Every kind and every SHAPES batch size (and none): the reference's
    ``rules_for`` reads only ``axis_names`` and ``shape``, so it takes the
    same stand-in mesh."""
    batches = sorted({s.global_batch for s in SHAPES.values()}) + [None]
    for kind in KINDS:
        for b in batches:
            assert rules_for(mesh, batch_size=b, kind=kind) == \
                jax_rules_for(mesh, batch_size=b, kind=kind), (kind, b)


def test_production_and_host_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert set(rules_for(make_host_mesh()).values()) == {None}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_param_axes_and_pspecs_equal_the_reference(arch):
    """Full-size configs, abstract parameters: every path's logical axes,
    and its spec under the single- and the multi-pod rules."""
    tm, jm = build_model(get_config(arch), device="cpu"), \
        jax_build_model(jax_get_config(arch))
    tl, jl = _flat(tm.param_logical()), _flat(jm.param_logical())
    assert tl == jl
    for rules in (rules_single_pod(), rules_multi_pod()):
        with use_mesh(None, rules):
            ts = _flat(tm.param_pspecs())
        with jax_use_mesh(None, rules):
            js = _flat(jm.param_pspecs())
        assert set(ts) == set(js)
        for k in ts:
            assert isinstance(ts[k], P)
            assert _spec(ts[k]) == _spec(js[k]), k
    shapes = {k: tuple(v.shape) for k, v in _flat(tm.abstract_params()).items()}
    assert shapes == {k: tuple(v.shape) for k, v in
                      _flat(jm.abstract_params()).items()}


def _runnable_cells():
    return [(a, s) for a in sorted(ARCHITECTURES) for s in sorted(SHAPES)
            if cell_is_runnable(get_config(a), get_shape(s))[0]]


@pytest.mark.parametrize("arch,shape_name", _runnable_cells())
def test_batch_and_cache_specs_equal_the_reference(arch, shape_name):
    """Shapes, dtypes and specs under the production mesh's rules for the
    cell (``rules_for(..., kind=shape.kind)``); caches on ``meta`` for the
    decode shapes."""
    shape = get_shape(shape_name)
    mesh = make_production_mesh()
    rules = rules_for(mesh, batch_size=shape.global_batch, kind=shape.kind)
    with use_mesh(mesh, rules):
        tsds, tps = batch_specs(get_config(arch), shape)
    with jax_use_mesh(None, rules):
        jsds, jps = jax_batch_specs(jax_get_config(arch),
                                    jax_get_shape(shape_name))
    assert set(tsds) == set(jsds) and set(tps) == set(jps)
    for k in tsds:
        assert tuple(tsds[k].shape) == tuple(jsds[k].shape), k
        assert tsds[k].dtype == TDT[jnp.dtype(jsds[k].dtype).name], k
        assert _spec(tps[k]) == _spec(jps[k]), k
    if shape.kind != "decode":
        return
    with use_mesh(mesh, rules):
        tc, tcs = cache_specs(build_model(get_config(arch), device="cpu"),
                              shape)
    with jax_use_mesh(None, rules):
        jc, jcs = jax_cache_specs(jax_build_model(jax_get_config(arch)),
                                  jax_get_shape(shape_name))
    tc, tcs, jc, jcs = _flat(tc), _flat(tcs), _flat(jc), _flat(jcs)
    assert set(tc) == set(jc) == set(tcs) == set(jcs)
    for k in tc:
        assert tc[k].device.type == "meta"
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert tc[k].dtype == TDT[jnp.dtype(jc[k].dtype).name], k
        assert _spec(tcs[k]) == _spec(jcs[k]), k


def test_matmul_params_and_model_flops_equal_the_reference():
    for arch in sorted(ARCHITECTURES):
        assert _matmul_params(get_config(arch)) == \
            jax_roofline._matmul_params(jax_get_config(arch)), arch
        for s in sorted(SHAPES):
            assert model_flops(arch, s) == jax_roofline.model_flops(arch, s)


def test_hillclimb_cells_equal_the_reference():
    assert hillclimb.CELLS == jax_hillclimb.CELLS
    assert hillclimb.EXTRA_MOE == jax_hillclimb.EXTRA_MOE


# ------------------------------------------------------------- sharding

def test_sharding_state_and_helpers():
    x = torch.ones(2, 3)
    assert logical_to_pspec(("batch", None)) == P()
    assert sharding.shard(x, "batch", None) is x
    assert sharding.current_mesh() is None and sharding.named_sharding(
        ("batch",)) is None
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    with use_mesh(mesh, rules_multi_pod()):
        assert logical_to_pspec(("batch", None, None)) == P(("pod", "data"))
        assert logical_to_pspec((None, "model")) == P(None, "model")
        assert sharding.mesh_axis("batch") == (("pod", "data"), 32)
        assert sharding.mesh_axis("seq") == (None, 1)
        assert sharding.named_sharding(("fsdp",)) == (mesh, P(("pod", "data")))
        assert sharding.shard(x, "batch", None) is x
        with use_mesh(None, None):
            assert sharding.current_mesh() is None
        assert sharding.current_mesh() is mesh
        assert sharding.shard_shape((33, 8, 5), P(("pod", "data"), "model"),
                                    mesh) == (2, 1, 5)
    assert sharding.current_mesh() is None
    if torch.cuda.device_count() <= 1:
        assert sharding.lane_mesh() is None
    assert sharding.lane_mesh([torch.device("cpu")]) is None
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    lanes = sharding.lane_mesh(cards)
    assert lanes.shape == {"lanes": 2} and lanes.devices == cards
    assert sharding.lane_count(None) == 1 and sharding.lane_count(lanes) == 2


# ------------------------------------------------------------- dry-run

REF_MEMORY = textwrap.dedent("""
    import os, dataclasses, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.configs import get_config, reduced
    from repro.launch import dryrun
    out = {}
    for arch in ("granite-3-8b", "deepseek-moe-16b"):
        cfg = get_config(arch)
        r = reduced(cfg)
        ov = {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
              if getattr(r, f.name) != getattr(cfg, f.name)}
        for shape in ("train_4k", "decode_32k"):
            lowered, _, _, _ = dryrun.build_cell(arch, shape, False,
                                                 overrides=ov,
                                                 mesh_shape=(2, 4))
            out[arch + "/" + shape] = dryrun._mem_dict(lowered.compile())
    print("RESULT", json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_memory():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_MEMORY], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT"))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-moe-16b"])
def test_dryrun_memory_equals_the_reference(ref_memory, arch, shape):
    """Reduced dense and MoE cells on a (2,4) mesh: per-device argument and
    output bytes equal XLA's ``memory_analysis()`` of the reference's
    compiled cell exactly."""
    ov = _reduced_overrides(arch)
    cell = dryrun.build_cell(arch, shape, False, overrides=ov,
                             mesh_shape=(2, 4))
    rec = dryrun.measure_cell(cell)
    want = ref_memory[f"{arch}/{shape}"]
    got = rec["memory_analysis"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert got["output_size_in_bytes"] == want["output_size_in_bytes"]
    assert got["temp_size_in_bytes"] is None
    assert tuple(rec["collective_bytes"]) == dryrun.COLLECTIVES
    assert rec["extrapolated"]["wire"] == rec["collective_wire_bytes"]
    assert rec["num_devices"] == 8
    assert rec["flops"] == rec["global_flops"] / 8 > 0


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-8b", ShapeConfig("train_s64", 64, 4, "train")),
    ("deepseek-moe-16b", ShapeConfig("train_s64", 64, 4, "train")),
    ("mamba2-130m", ShapeConfig("train_s64", 64, 4, "train")),
    ("gemma2-2b", ShapeConfig("prefill_s64", 64, 2, "prefill")),
    ("recurrentgemma-2b", ShapeConfig("decode_s64", 64, 2, "decode")),
    ("seamless-m4t-large-v2", ShapeConfig("decode_s64", 64, 2, "decode")),
])
def test_meta_counts_equal_the_same_step_on_cpu_tensors(arch, shape):
    """The step counted on ``meta`` and the same step on materialised CPU
    tensors: FLOPs equal exactly; bytes too but for one copy (a train step's
    AdamW moves its host learning-rate scalar to the parameters' device:
    4 bytes read and 4 written on ``meta``, as on a card, and no copy at all
    when that device is the CPU) and, for the MoE, ``F.one_hot``, which
    runs another decomposition on ``meta`` (arange + eq) than on a real
    device (a range check + scatter): within 2% there.  The argument bytes
    of the host mesh equal the tensors' own bytes."""
    ov = _reduced_overrides(arch)
    cell = dryrun.build_cell(arch, shape, False, overrides=ov,
                             mesh_shape=(1, 1))
    _, f_meta, b_meta = dryrun.count_step(cell.step, cell.args)
    args = dryrun.real_args(cell, "cpu", seed=0)
    outs, f_cpu, b_cpu = dryrun.count_step(cell.step, args)
    assert f_meta == f_cpu > 0
    b_meta -= 8 if shape.kind == "train" else 0
    if cell.cfg.num_experts:
        assert abs(b_meta - b_cpu) <= 0.02 * b_cpu
    else:
        assert b_meta == b_cpu > 0
    held = dryrun._tensor_bytes(args)
    assert dryrun.memory_analysis(cell, outs)["argument_size_in_bytes"] \
        == held


def test_byte_counter_skips_views_and_counts_writes():
    a, b = torch.ones(4, 8), torch.ones(4, 8)
    with dryrun.ByteCounter() as bc:
        v = a.view(8, 4).t()                     # views: nothing
        assert bc.bytes == 0
        c = a + b                                # 3 x 128 bytes
        c.add_(b)                                # c read, b read, c written
        torch.mul(a, 2.0, out=c)                 # a read, c written
    assert bc.bytes == 3 * 128 + 3 * 128 + 2 * 128 and v.shape == (4, 8)


def test_dryrun_roofline_hillclimb_write_their_records(tmp_path, monkeypatch):
    """mamba2-130m long_500k (a decode cell, fast on ``meta``): the record,
    the roofline table from it, and the hillclimb's three variants; both
    CLIs refuse to run without a card unless ``--device cpu``."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(roofline, "OUT_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(roofline, "MD_OUT", tmp_path / "roofline_torch.md")
    monkeypatch.setattr(hillclimb, "HC_DIR", tmp_path / "hillclimb_torch")
    monkeypatch.setattr(hillclimb, "load_cell", lambda a, s, m: None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hillclimb.main(["--cell", "long"])
    for multi in (False, True):
        rec = dryrun.run_cell("mamba2-130m", "long_500k", multi,
                              out_dir=tmp_path / "dryrun_torch", device="cpu")
        assert rec["runnable"] and rec["fits"]
        assert rec["device_memory_bytes"] == 80e9
        assert rec["extrapolated"]["flops"] == rec["flops"] > 0
    skip = dryrun.run_cell("gemma2-2b", "long_500k", False,
                           out_dir=tmp_path / "dryrun_torch", device="cpu")
    assert not skip["runnable"] and "quadratic" in skip["skip_reason"]
    roofline.main(["--mesh", "pod16x16"])
    table = (tmp_path / "roofline_torch.md").read_text()
    assert "| mamba2-130m | long_500k |" in table and "skipped" in table
    assert "450 GB/s link" in table
    assert "TPU" not in table and "Pallas" not in table and "ICI" not in table
    t = roofline.cell_terms(rec)
    assert t["t_collective"] == sum(rec["extrapolated"]["wire"].values()) \
        / 450e9 > 0
    terms = {k: t[f"t_{k}"] for k in ("compute", "memory", "collective")}
    assert t["dominant"] == max(terms, key=terms.get) == "collective"
    res = hillclimb.run_cell_variants("long", device="cpu")
    assert set(res) == {"baseline", "tp_off", "slice_4x4", "slice_1x4"}
    assert res["slice_4x4"]["num_devices"] == 16
    assert res["slice_4x4"]["global_flops"] == res["baseline"]["global_flops"]
    assert len(list((tmp_path / "hillclimb_torch").glob("*.json"))) == 3


# ------------------------------------------------------------- the example

def _example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import autotune_sharding_torch as ex
        import autotune_sharding as jax_ex
    finally:
        sys.path.pop(0)
    return ex, jax_ex


def test_example_simulates_what_the_reference_simulates(monkeypatch):
    """Each layout's simulated step (the port's epoch scan, plain version on
    the CPU) equals the reference simulator's on the same per-layer costs
    (the reference's ``build_soc`` with no collective time) within 1e-6
    relative; no record is read (the analytic fallback)."""
    ex, jax_ex = _example()
    monkeypatch.setattr(ex, "load_cell", lambda *a: None)
    from repro.core import deterministic_trace, get_scheduler, simulate
    rows = ex.simulate_layouts("granite-3-8b", "train_4k", "cpu")
    app = jax_ex.Application("train_step", tuple(
        jax_ex.Task("layer", i, (i - 1,) if i else (), 1024.0)
        for i in range(16)))
    n = get_config("granite-3-8b").num_layers
    for (name, comp, wire, step_ms), (cname, _, _, accum) in zip(
            rows, ex.CANDIDATES):
        assert name == cname and wire == pytest.approx(
            comp * 1e-6 * n * ex.PEAK_FLOPS_BF16 * 0.002, rel=1e-9)
        db = jax_ex.build_soc(name, comp * n / 16 / accum, 0.0)
        res = simulate(db, [app], deterministic_trace(0.001, accum,
                                                      ["train_step"]),
                       get_scheduler("etf"))
        assert step_ms == pytest.approx(res.makespan_us / 1e3, rel=1e-6)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "autotune_sharding_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "selected layout:" in proc.stdout
