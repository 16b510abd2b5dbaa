"""Dry-run: count every (arch × shape × mesh) cell's step without a card.

The twin of ``src/repro/launch/dryrun.py``.  For each cell this builds the
real step function (train / prefill / decode) exactly as the reference's
``build_cell`` does — ``remat="full"`` for train, the same microbatch count
and accumulation dtype, ``AdamWConfig(moment_dtype="bfloat16")``, the rules
of ``rules_for(mesh, ...)`` — over parameters, optimizer state, batch and
cache on the ``meta`` device (shapes, no storage), runs it there at the
cell's global shapes and full depth, and records:

  * ``flops`` — the matmul-like ops' FLOPs that ``FlopCounterMode`` counts
    (XLA's count also holds elementwise work, so MODEL ÷ counted differs in
    meaning from the reference's MODEL ÷ HLO).  PyTorch runs every layer, so
    the count is of the full depth: the reference's R=1/R=2 probe pair and
    its ``extrapolate`` (XLA counts a scanned body once) are not needed;
  * ``bytes_accessed`` — each op's input plus output tensor bytes, summed
    over the step (:class:`ByteCounter`; views move nothing and are not
    counted): the eager analogue of XLA's "bytes accessed";
  * both per device as global ÷ devices, "perfectly partitioned", and under
    the reference's keys (``extrapolated.flops``, ``extrapolated.bytes``) so
    that ``roofline`` and the autotune example read them;
  * ``memory_analysis`` — per-device argument and output bytes from each
    leaf's spec and the mesh (a dimension split over mesh axes of total size
    k keeps ceil(d/k) rows; outputs also count the 8-byte pointer a leaf
    that XLA's output tuple holds), the twin of ``memory_analysis()``'s
    ``argument_size_in_bytes`` / ``output_size_in_bytes``; temporaries are
    not modelled (``None``).  A cell fits when its argument bytes are at
    most the card's memory (``--device cuda``: the card's; ``cpu``: the
    H100's 80 GB).

``collective_bytes`` / ``collective_wire_bytes`` / ``collective_counts``
come from a second run of the same step, partitioned: under
:func:`fake_world` (a fake process group of the mesh's size, rank 0, and a
``DeviceMesh`` with the mesh's axes) every argument is a ``DTensor`` holding
rank 0's block on ``meta`` (:func:`distribute`), the model's activation
constraints (``sharding.shard``) redistribute as the reference's
``with_sharding_constraint`` does, and :class:`CollectiveCounter` records
every collective the step issues as (kind, result bytes on rank 0, group
size).  :func:`collective_bytes` sums them under the reference's five kinds
and ring factors.  These are the collectives of one full-depth step, the
twin of the reference's ``extrapolated.coll`` / ``.wire`` (a step's
collectives from its R=1/R=2 probes), not of its ``collective_*`` (static op
counts of a program whose layer loop is scanned, so the body counts once);
the record carries them under both names.  DTensor's partitioner picks its
own collectives, not always XLA's kind (an all-gather where XLA takes an
all-to-all, say), so the counts are the port's, held to the reference's
arithmetic and to layouts derived by hand (tests/test_torch_collectives.py).

The plain count does not depend on the mesh beyond its microbatch count, so
one serves every mesh with the same microbatch count; the partitioned count
is kept per mesh and rules (``_COUNTS``).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``;
``launch/roofline.py`` aggregates them.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import resolve_device
from ..configs import (ARCHITECTURES, SHAPES, ShapeConfig, cell_is_runnable,
                       get_config, get_shape)
from ..models import Model, build_model
from ..models.params import tree_leaves
from ..optim import AdamWConfig
from ..sharding import (Mesh, P, logical_to_pspec, placements,
                        shard_shape, use_mesh)
from .mesh import HBM_BYTES, make_production_mesh, rules_for
from .specs import batch_specs, cache_specs, enc_len_of
from .steps import (init_opt_state, make_prefill_step, make_serve_step,
                    make_train_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
META = torch.device("meta")
TUPLE_POINTER_BYTES = 8        # a leaf's slot in XLA's output tuple


class ByteCounter(TorchDispatchMode):
    """Sums each op's input and output tensor bytes.  An op that returns a
    view of an input (an alias it does not write) moves nothing and is not
    counted; an in-place op's written input counts as read and written; an
    ``out=`` tensor counts once, as written."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rets = func._schema.returns
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets):
            reads = {k: v for k, v in kwargs.items() if k != "out"}
            self.bytes += _tensor_bytes((args, reads)) + _tensor_bytes(out)
            self.ops += 1
        return out


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Cell:
    """A cell's step, its abstract arguments and their specs."""
    arch: str
    shape: ShapeConfig
    cfg: Any
    mesh: Mesh
    rules: Dict[str, Any]
    model: Model
    step: Any
    args: Tuple                    # meta tensors, in the step's order
    arg_specs: Tuple               # a P or a spec tree per argument
    accum: int = 1

    def out_specs(self) -> Tuple:
        """Specs of the step's outputs: parameters and optimizer state as
        their inputs, metrics and the next token replicated, the cache by
        its spec rule, logits ("batch", None, "model") (the layout the
        reference's compiler picks for a decode cell's logits)."""
        kind = self.shape.kind
        if kind == "train":
            return self.arg_specs[0], self.arg_specs[1], P()
        with use_mesh(self.mesh, self.rules):
            logits = logical_to_pspec(("batch", None, "model"))
            if kind == "prefill":
                return logits, cache_specs(self.model, self.shape)[1]
        return P(), logits, self.arg_specs[1]


def _resolve_shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return get_shape(shape) if isinstance(shape, str) else shape


def build_cell(arch: str, shape_name: Union[str, ShapeConfig],
               multi_pod: bool, overrides: Optional[dict] = None,
               rules_patch: Optional[dict] = None,
               mesh_shape: Optional[tuple] = None) -> Cell:
    """The cell's step over ``meta`` arguments under its mesh and rules
    (``mesh_shape``: a (data, model) slice in place of the production
    mesh).  ``shape_name`` may be a :class:`ShapeConfig` of its own."""
    cfg = get_config(arch).replace(attn_impl="blocked")
    shape = _resolve_shape(shape_name)
    if shape.kind == "train":
        # baseline: full per-superblock activation checkpointing
        cfg = cfg.replace(remat="full")
    if overrides:
        cfg = cfg.replace(**overrides)
    if mesh_shape is not None:
        mesh = Mesh(tuple(mesh_shape), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_for(mesh, batch_size=shape.global_batch, kind=shape.kind)
    if rules_patch:
        rules.update(rules_patch)

    with use_mesh(mesh, rules):
        model = build_model(cfg, device=META)
        params = model.abstract_params()
        params_ps = model.param_pspecs()
        batch, b_ps = batch_specs(cfg, shape)
        accum = 1
        if shape.kind == "train":
            # microbatch so each data shard sees 4 sequences per microbatch
            # (1 for wide models), as the reference's cell
            dp = mesh.shape["data"] * mesh.shape.get("pod", 1)
            per_shard = max(1, shape.global_batch // dp)
            per_micro = 4 if cfg.d_model < 4096 else 1
            accum = max(1, per_shard // per_micro)
            adt = "bfloat16" if cfg.d_model >= 4096 else "float32"
            step = make_train_step(model, AdamWConfig(moment_dtype="bfloat16"),
                                   accum_steps=accum, accum_dtype=adt)
            opt = init_opt_state(params, abstract=True,
                                 moment_dtype="bfloat16")
            # optimizer state shards exactly like params; step is replicated
            opt_ps = {"master": params_ps, "mu": params_ps, "nu": params_ps,
                      "step": P()}
            args, specs = (params, opt, batch), (params_ps, opt_ps, b_ps)
        elif shape.kind == "prefill":
            step = make_prefill_step(model, max_len=shape.seq_len)
            args, specs = (params, batch), (params_ps, b_ps)
        else:                                   # decode
            step = make_serve_step(model)
            cache, c_ps = cache_specs(model, shape)
            pos = torch.zeros((), dtype=torch.int32, device=META)
            args = (params, cache, batch["tokens"], pos)
            specs = (params_ps, c_ps, b_ps["tokens"], P())
    return Cell(arch, shape, cfg, mesh, rules, model, step, args, specs,
                accum)


def count_step(step, args) -> Tuple[Any, int, int]:
    """(outputs, matmul FLOPs, bytes) of one call ``step(*args)``."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        out = step(*args)
    return out, int(fc.get_total_flops()), int(bc.bytes)


def _spec_pairs(value, spec):
    """(leaf, spec) pairs of a value tree; a P spec covers a whole subtree."""
    if isinstance(spec, P):
        return [(leaf, spec) for leaf in tree_leaves(value)]
    if isinstance(value, (tuple, list)):
        return [pr for v, s in zip(value, spec) for pr in _spec_pairs(v, s)]
    return [pr for k in value for pr in _spec_pairs(value[k], spec[k])]


def per_device_bytes(values, specs, mesh: Mesh) -> Tuple[int, int]:
    """(bytes one device holds, leaves) of a value tree laid out by specs."""
    pairs = _spec_pairs(values, specs)
    total = sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
                for t, s in pairs)
    return total, len(pairs)


def memory_analysis(cell: Cell, outs) -> Dict[str, Optional[int]]:
    arg_b, _ = per_device_bytes(cell.args, cell.arg_specs, cell.mesh)
    out_b, n_out = per_device_bytes(outs, cell.out_specs(), cell.mesh)
    return {"argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b + TUPLE_POINTER_BYTES * n_out,
            "temp_size_in_bytes": None}


def device_memory_bytes(device) -> int:
    """The card's memory (``cuda``), or the H100's 80 GB data-sheet figure
    when the dry-run is driven from the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(HBM_BYTES)


def real_args(cell: Cell, device, seed: int = 0) -> Tuple:
    """The cell's arguments materialised on ``device``: seeded random
    parameters, their optimizer state, a random batch and an empty cache,
    with the meta arguments' shapes and dtypes."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = cell.model.init_params(gen, device=dev)

    def like(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, dtype=torch.float32,
                               device=dev).to(t.dtype)
        return torch.randint(0, cell.cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype, device=dev)

    if cell.shape.kind == "train":
        opt = init_opt_state(params, moment_dtype="bfloat16")
        return params, opt, {k: like(v) for k, v in cell.args[2].items()}
    if cell.shape.kind == "prefill":
        return params, {k: like(v) for k, v in cell.args[1].items()}
    cache = cell.model.init_cache(cell.shape.global_batch,
                                  cell.shape.seq_len, device=dev,
                                  enc_len=enc_len_of(cell.cfg, cell.shape))
    return (params, cache, like(cell.args[2]),
            torch.zeros((), dtype=torch.int32, device=dev))


# ------------------------------------------------ the partitioned count

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collectives (``torch.ops._c10d_functional``) by kind; the
# position of the group size among the arguments, or None (resolve the group)
_FUNCOL = {"all_gather_into_tensor": ("all-gather", 1),
           "all_gather_into_tensor_coalesced": ("all-gather", 1),
           "all_reduce": ("all-reduce", None),
           "all_reduce_coalesced": ("all-reduce", None),
           "reduce_scatter_tensor": ("reduce-scatter", 2),
           "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
           "all_to_all_single": ("all-to-all", None)}

Collective = collections.namedtuple("Collective", "kind nbytes group")


@contextlib.contextmanager
def fake_world(mesh: Mesh, device_type: str = "cpu"):
    """A fake process group of ``mesh.size`` ranks (this process is rank 0;
    collectives move nothing) and a ``DeviceMesh`` of ``device_type`` with
    the mesh's axis names and sizes, yielded; the group is destroyed on exit.
    Refuses to start while a process group exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, mesh.axis_sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def distribute(values, specs, device_mesh, mesh: Mesh):
    """The value tree as ``DTensor``s over ``device_mesh``: each leaf holds
    rank 0's block of its layout (``spec`` on ``mesh``) on the leaf's own
    device, with the leaf's global shape and stride.  A dimension its axes
    do not divide keeps ceil(d/k) rows on rank 0, as ``memory_analysis``
    counts them (DTensor's uneven split, ``torch.chunk``'s)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        block = t[tuple(slice(0, n) for n in shard_shape(t.shape, spec, mesh))]
        return DTensor.from_local(block.contiguous(), device_mesh,
                                  placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(v, spec):
        if isinstance(spec, P):
            if isinstance(v, torch.Tensor):
                return one(v, spec)
            if isinstance(v, dict):
                return {k: walk(x, spec) for k, x in v.items()}
            return type(v)(walk(x, spec) for x in v)
        if isinstance(v, (tuple, list)):
            return type(v)(walk(x, sp) for x, sp in zip(v, spec))
        return {k: walk(v[k], spec[k]) for k in v}

    return walk(values, specs)


class CollectiveCounter(TorchDispatchMode):
    """Records each collective a ``DTensor`` program issues as
    :data:`Collective` (kind, result bytes on rank 0, group size), in order.

    DTensor's resharding all-to-all (``shard_dim_alltoall``) is one
    all-to-all on every device type: on a CPU mesh DTensor runs it as an
    all-gather and a chunk, and on a CUDA mesh as its own op, so the counter
    wraps the function and records the all-to-all itself, ignoring the
    collectives issued inside it.  A collective of another kind raises."""

    def __init__(self):
        super().__init__()
        self.events: List[Collective] = []
        self._inside_a2a = 0
        self._patched = []

    def _wrap_a2a(self, fn):
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._inside_a2a += 1
            try:
                out = fn(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._inside_a2a -= 1
            self.events.append(Collective(
                "all-to-all", out.numel() * out.element_size(),
                mesh.size(mesh_dim)))
            return out
        return shard_dim_alltoall

    def __enter__(self):
        import sys
        from torch.distributed.tensor import _collective_utils as cu
        orig = cu.shard_dim_alltoall
        wrapped = self._wrap_a2a(orig)
        for name, mod in list(sys.modules.items()):
            if name.startswith("torch.distributed.tensor") and \
                    getattr(mod, "shard_dim_alltoall", None) is orig:
                self._patched.append((mod, orig))
                mod.shard_dim_alltoall = wrapped
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, orig in self._patched:
            mod.shard_dim_alltoall = orig
        self._patched.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented         # let DTensor lower to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", None)
        if ns not in ("_c10d_functional", "_dtensor") or self._inside_a2a:
            return out
        name = func._overloadpacket.__name__
        if name in ("wait_tensor", "_wrap_tensor_autograd"):
            return out                    # bookkeeping, not collectives
        if name == "shard_dim_alltoall":
            raise RuntimeError("shard_dim_alltoall outside the counter's "
                               "wrapper")
        if name not in _FUNCOL:
            raise NotImplementedError(f"collective {func} is not counted")
        kind, gpos = _FUNCOL[name]
        if gpos is not None:
            group = int(args[gpos])
        else:
            from torch.distributed import distributed_c10d as c10d
            group = c10d._resolve_process_group(args[-1]).size()
        self.events.append(Collective(kind, _tensor_bytes(out), group))
        return out


def collective_bytes(events: Iterable) -> Tuple[dict, dict, dict]:
    """(result bytes, wire bytes, counts) per kind, under the reference's
    five keys, from (kind, result bytes, group) events, with the reference's
    ring factors: all-reduce wire = 2 x result, reduce-scatter wire =
    result x group, the others = result."""
    res = {k: 0 for k in COLLECTIVES}
    wire = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes, group in events:
        res[kind] += nbytes
        counts[kind] += 1
        if kind == "all-reduce":
            wire[kind] += 2 * nbytes
        elif kind == "reduce-scatter":
            wire[kind] += nbytes * group
        else:
            wire[kind] += nbytes
    return res, wire, counts


# aten ops DTensor has no sharding strategy for, on a path the dry-run runs
# (the MoE sort form's searchsorted): each is given one that replicates its
# tensor inputs, so DTensor gathers them first (counted, as XLA's are)
_REPLICATED_OPS = ("searchsorted.Tensor",)
_registered: List[str] = []


def _register_replicated_ops():
    if _registered:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding
    for name in _REPLICATED_OPS:
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)

        def replicated(*args, **kwargs):
            return [([Replicate()], [Replicate() if hasattr(a, "ndim")
                                     else None for a in args])]
        register_sharding(op)(replicated)
        _registered.append(name)


def count_collectives(step, args, mesh: Mesh, rules, specs,
                      device_type: str = "cpu") -> Tuple[List[Collective],
                                                         Any]:
    """(collectives, outputs) of one call ``step(*args)`` partitioned over
    ``mesh`` under ``rules``: the arguments distributed by ``specs`` in a
    :func:`fake_world`, the tensors the step makes itself replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_replicated_ops()
    with fake_world(mesh, device_type) as dm, \
            use_mesh(mesh, rules, device_mesh=dm):
        dargs = distribute(args, specs, dm, mesh)
        with CollectiveCounter() as cc, implicit_replication():
            out = step(*dargs)
    return cc.events, out


def mesh_name_of(multi_pod: bool, mesh_shape: Optional[tuple] = None) -> str:
    if mesh_shape is not None:
        return "slice" + "x".join(str(s) for s in mesh_shape)
    return "pod2x16x16" if multi_pod else "pod16x16"


# the plain count per program: (config, shape, microbatches) -> counts; the
# partitioned count per program, mesh and rules
_COUNTS: Dict[tuple, dict] = {}


def _rules_key(rules) -> tuple:
    return tuple(sorted(rules.items()))


def measure_cell(cell: Cell) -> dict:
    """Count the cell's step on ``meta`` (once per program), then its
    collectives partitioned over the cell's mesh (once per program and
    mesh), and size its per-device memory; the record's numeric fields."""
    key = (cell.cfg, cell.shape, cell.accum)
    if key not in _COUNTS:
        t0 = time.time()
        outs, flops, nbytes = count_step(cell.step, cell.args)
        _COUNTS[key] = dict(count_s=round(time.time() - t0, 2), flops=flops,
                            nbytes=nbytes, outs=outs)
    c = _COUNTS[key]
    pkey = key + (cell.mesh, _rules_key(cell.rules))
    if pkey not in _COUNTS:
        t0 = time.time()
        events, _ = count_collectives(cell.step, cell.args, cell.mesh,
                                      cell.rules, cell.arg_specs)
        _COUNTS[pkey] = dict(count_s=round(time.time() - t0, 2),
                             coll=collective_bytes(events))
    pc = _COUNTS[pkey]
    cres, cwire, ccounts = pc["coll"]
    nd = cell.mesh.size
    mem = memory_analysis(cell, c["outs"])
    return dict(
        count_s=c["count_s"], num_devices=int(nd), microbatches=cell.accum,
        global_flops=float(c["flops"]), global_bytes=float(c["nbytes"]),
        flops=c["flops"] / nd, bytes_accessed=c["nbytes"] / nd,
        partitioning="perfectly partitioned: global / devices",
        flops_counted="matmul-like ops (torch FlopCounterMode), full depth",
        bytes_counted="each op's input + output tensor bytes (eager analogue"
                      " of XLA's bytes accessed)",
        memory_analysis=mem,
        collective_count_s=pc["count_s"],
        collectives_counted="the full-depth step run as DTensors over a fake "
                            "process group: result bytes on rank 0, ring "
                            "wire factors",
        collective_bytes=dict(cres), collective_wire_bytes=dict(cwire),
        collective_counts=dict(ccounts),
        extrapolated={"flops": c["flops"] / nd, "bytes": c["nbytes"] / nd,
                      "coll": dict(cres), "wire": dict(cwire)},
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[Path] = None, save: bool = True,
             device="cuda", mesh_shape: Optional[tuple] = None) -> dict:
    out_dir = OUT_DIR if out_dir is None else out_dir
    mesh_name = mesh_name_of(multi_pod, mesh_shape)
    cfg = get_config(arch)
    shape = _resolve_shape(shape_name)
    ok, reason = cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "runnable": ok}
    if not ok:
        rec["skip_reason"] = reason
        print(f"[dryrun] SKIP {arch} × {shape.name} × {mesh_name}: {reason}")
    else:
        t0 = time.time()
        cell = build_cell(arch, shape, multi_pod, mesh_shape=mesh_shape)
        rec["build_s"] = round(time.time() - t0, 2)
        rec.update(measure_cell(cell))
        cap = device_memory_bytes(device)
        rec["device_memory_bytes"] = cap
        rec["fits"] = rec["memory_analysis"]["argument_size_in_bytes"] <= cap
        print(f"[dryrun] OK {arch} × {shape.name} × {mesh_name} "
              f"count={rec['count_s']}s flops/dev={rec['flops']:.3e} "
              f"bytes/dev={rec['bytes_accessed']:.3e} (perfectly "
              f"partitioned) fits={rec['fits']}")
        print(f"  collectives ({rec['collective_count_s']} s): counts "
              f"{rec['collective_counts']} wire bytes "
              f"{sum(rec['collective_wire_bytes'].values()):.3e}")
        print(f"  memory_analysis: {rec['memory_analysis']}")
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{arch}__{shape.name}__{mesh_name}.json"
        path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the card whose memory a cell must fit (default "
                         "cuda; cpu: the H100's 80 GB)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    archs = sorted(ARCHITECTURES) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.time()
    for a in archs:
        for s in shapes:
            for m in meshes:
                path = OUT_DIR / f"{a}__{s}__{mesh_name_of(m)}.json"
                if args.skip_existing and path.exists():
                    print(f"[dryrun] cached {path.name}")
                    continue
                run_cell(a, s, m, device=args.device)
            _COUNTS.clear()             # both meshes of a cell share a count
    print(f"\n[dryrun] all cells passed in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
