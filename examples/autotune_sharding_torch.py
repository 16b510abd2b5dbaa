"""The paper ↔ pod bridge on the PyTorch port: DS3 choosing a model's layout.

The twin of ``examples/autotune_sharding.py``.  The *resource database* is
populated with per-layer costs derived from the port's dry-run records
(``python -m repro_torch.launch.dryrun``) or, where no record exists, from
the analytic ``model_flops``, with an H100's data-sheet peak
(``repro_torch.launch.mesh``); candidate pod layouts play the role of
candidate SoC configurations, and the port's simulator (the epoch scan, K1
on the card) evaluates a training step against each, with the ETF
scheduler.  The layout with the best simulated step time is selected.

A record's collective wire bytes (``extrapolated.wire``: the step run as
DTensors over a fake process group of the 16×16 mesh) are taken when the
record has them, scaled to the layout as the reference scales them; without
a record, the reference's fallback, 0.002 bytes a FLOP.  They are printed
with their time at the H100's NVLink data-sheet rate (``LINK_BW``) beside
the per-layer cost and not priced into it: no link is measured on a
one-card machine, so the simulated costs are compute only.

    PYTHONPATH=src python examples/autotune_sharding_torch.py \
        --arch granite-3-8b [--device cpu]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (PE, Application, CommModel, ResourceDB, Task,
                              build_tables, deterministic_trace,
                              simulate_torch)
from repro_torch.launch.mesh import LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.roofline import load_cell, model_flops

# candidate pod layouts: (name, data_par, model_par, accum)
CANDIDATES = [
    ("dp32_tp8", 32, 8, 8),
    ("dp16_tp16", 16, 16, 16),
    ("dp8_tp32", 8, 32, 32),
]
WIRE_BYTES_PER_FLOP = 0.002          # the reference's fallback heuristic


def layer_costs_us(arch: str, shape_name: str, dp: int, tp: int):
    """Per-layer (compute us, collective bytes a device) for a layout."""
    cfg = get_config(arch)
    rec = load_cell(arch, shape_name, "pod16x16")
    chips = dp * tp
    ex = (rec or {}).get("extrapolated") or {}
    if ex:
        flops_dev = ex["flops"] * 256 / chips
    else:
        flops_dev = model_flops(arch, shape_name) / chips * 1.4  # remat tax
    if ex.get("wire"):                  # older records hold no collectives
        wire_dev = sum(ex["wire"].values()) * 256 / chips
        # TP collectives scale with tp relative to the measured 16-way layout
        wire_dev *= tp / 16
    else:
        wire_dev = flops_dev * WIRE_BYTES_PER_FLOP
    n = cfg.num_layers + cfg.num_encoder_layers
    comp_us = flops_dev / PEAK_FLOPS_BF16 / n * 1e6
    return comp_us, wire_dev


def build_soc(name: str, comp_us: float, n_stages: int = 4):
    """Model the pod's model-parallel groups as PEs, each layer task
    taking ``comp_us``."""
    pes = [PE(i, "A15", cluster=0, name=f"{name}-grp{i}")
           for i in range(n_stages)]
    profiles = {"layer": {"A15": comp_us}}
    return ResourceDB(pes, profiles, CommModel(0.0, 1e12))


def chain_app(n_layers: int) -> Application:
    """A training step as a chain DAG of layer tasks (the paper's job)."""
    return Application("train_step", tuple(
        Task("layer", i, (i - 1,) if i else (), 1024.0)
        for i in range(min(n_layers, 16))))


def layouts(arch: str, shape: str):
    """Per candidate: (name, per-layer comp us, coll bytes, the SoC, the
    chain application, the trace of its microbatch chains)."""
    cfg = get_config(arch)
    n_layers = cfg.num_layers + cfg.num_encoder_layers
    app = chain_app(n_layers)
    for name, dp, tp, accum in CANDIDATES:
        comp, wire = layer_costs_us(arch, shape, dp, tp)
        # per-microbatch layer cost: the step's work divides over `accum`
        db = build_soc(name, comp * n_layers / len(app.tasks) / accum)
        # `accum` microbatch chains injected together: ETF pipelines them
        # across the model-parallel groups (the paper's job-interleaving)
        trace = deterministic_trace(0.001, accum, ["train_step"])
        yield name, comp, wire, db, app, trace


def simulate_layouts(arch: str, shape: str, device="cuda"):
    """[(name, per-layer comp us, coll bytes, simulated step ms)] for
    every candidate, one K1 launch each."""
    dev = resolve_device(device)
    rows = []
    for name, comp, wire, db, app, trace in layouts(arch, shape):
        out = simulate_torch(build_tables(db, [app], device=dev), "etf",
                             trace.arrival_us, trace.app_index)
        rows.append((name, comp, wire, float(out["makespan_us"]) / 1e3))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain scan)")
    args = ap.parse_args(argv)

    print(f"autotuning {args.arch} × {args.shape} over {len(CANDIDATES)} "
          f"layouts (DS3 ETF simulation on the port's epoch scan):\n")
    rows = simulate_layouts(args.arch, args.shape, args.device)
    cfg = get_config(args.arch)
    n_layers = cfg.num_layers + cfg.num_encoder_layers
    for name, comp, wire, step_ms in rows:
        coll_us = wire / LINK_BW / n_layers * 1e6
        print(f"  {name:<10} per-layer comp={comp:8.1f}us coll={coll_us:8.1f}us"
              f" at NVLink ({wire:.3e} B/dev) -> simulated step "
              f"{step_ms:9.2f} ms")
    best = min(rows, key=lambda r: r[3])
    print(f"\nselected layout: {best[0]}  ({best[3]:.2f} ms/step simulated)")


if __name__ == "__main__":
    main()
