"""Perf hillclimbing harness: hypothesis → change → measure.

The twin of ``src/repro/launch/hillclimb.py``.  Each VARIANT of a cell
re-builds the full production step with config overrides (and optionally
patched sharding rules or another mesh shape), re-counts it on ``meta``
(``launch/dryrun.py``: FLOPs and bytes, and the collectives of the step
partitioned over the variant's mesh), re-derives the roofline terms with the
H100's figures, and records them beside the dry-run baseline.  Results land in
``experiments/hillclimb_torch/``.

A variant whose cell is not runnable (``cell_is_runnable``) is skipped with
its reason; any other failure is the port's and stops the run.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe
"""
from __future__ import annotations

import argparse
import json

from .. import resolve_device
from ..configs import cell_is_runnable, get_config, get_shape
from .dryrun import OUT_DIR, build_cell, measure_cell, mesh_name_of, run_cell
from .roofline import cell_terms, load_cell

HC_DIR = OUT_DIR.parent / "hillclimb_torch"

# variant = (name, cfg overrides, rules patch[, mesh shape])
CELLS = {
    # (c) most paper-representative: MoE token dispatch IS the paper's
    # scheduling problem (tasks -> heterogeneous executors)
    "moe": ("deepseek-moe-16b", "train_4k", [
        ("moe_sort", {"moe_impl": "sort"}, None),
        ("moe_group_512", {"moe_group_size": 512}, None),
        ("moe_group_8192", {"moe_group_size": 8192}, None),
        ("moe_sort_selremat", {"moe_impl": "sort", "remat": "selective"}, None),
    ]),
    # (b) most collective-bound on the reference's pod: 132B weights
    # all-gathered per decoded token
    "decode": ("dbrx-132b", "decode_32k", [
        ("kv_int8", {"kv_cache_dtype": "int8"}, None),
        # weight-stationary decode: replicate the (tiny) batch activations,
        # keep weights resident-sharded; matmuls partial-sum over fsdp
        ("weight_stationary", {}, {"batch": None}),
        ("ws_kv_int8", {"kv_cache_dtype": "int8"}, {"batch": None}),
    ]),
    # (a) worst roofline fraction: B=1 long-context decode on a 130M SSM
    "long": ("mamba2-130m", "long_500k", [
        ("tp_off", {}, {"model": None, "expert": None, "kv_seq": None}),
        # right-size the deployment: a 4×4 serving slice (DS3-autotuner move)
        ("slice_4x4", {}, None, (4, 4)),
        ("slice_1x4", {}, None, (1, 4)),
    ]),
}

EXTRA_MOE = [
    ("group512_selremat", {"moe_group_size": 512, "remat": "selective"}, None),
    ("group512_bf16scores", {"moe_group_size": 512,
                             "attn_scores_f32": False}, None),
]
CELLS["moe"][2].extend(EXTRA_MOE)


def measure(arch, shape, overrides=None, rules_patch=None, mesh_shape=None):
    cell = build_cell(arch, shape, False, overrides=overrides,
                      rules_patch=rules_patch, mesh_shape=mesh_shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": mesh_name_of(False, mesh_shape), "runnable": True}
    rec.update(measure_cell(cell))
    return rec


def fmt(rec):
    t = cell_terms(rec)
    hbm = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0) / 1e9
    if t is None:
        return f"args={hbm:.1f}GB (not counted)"
    return (f"comp={t['t_compute']:.3e}s mem={t['t_memory']:.3e}s "
            f"coll={t['t_collective']:.3e}s dom={t['dominant']} "
            f"useful={t['model_flops_frac']:.2f} args={hbm:.1f}GB")


def run_cell_variants(key: str, device="cuda"):
    arch, shape, variants = CELLS[key]
    HC_DIR.mkdir(parents=True, exist_ok=True)
    base = load_cell(arch, shape, "pod16x16")
    if base is None:
        base = run_cell(arch, shape, False, device=device)
    print(f"=== {key}: {arch} × {shape} ===")
    print(f"baseline       : {fmt(base)}")
    results = {"baseline": base}
    for var in variants:
        name, ov, rp = var[0], var[1], var[2]
        ms = var[3] if len(var) > 3 else None
        ok, reason = cell_is_runnable(get_config(arch).replace(**ov),
                                      get_shape(shape))
        if not ok:
            print(f"{name:<15}: not runnable: {reason}")
            continue
        rec = measure(arch, shape, overrides=ov or None, rules_patch=rp,
                      mesh_shape=ms)
        results[name] = rec
        (HC_DIR / f"{arch}__{shape}__{name}.json").write_text(
            json.dumps(rec, indent=1))
        print(f"{name:<15}: {fmt(rec)}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["all"], default="all")
    ap.add_argument("--device", default="cuda",
                    help="the card whose memory a cell must fit (default "
                         "cuda; cpu: the H100's 80 GB)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    for key in (CELLS if args.cell == "all" else [args.cell]):
        run_cell_variants(key, device=args.device)


if __name__ == "__main__":
    main()
