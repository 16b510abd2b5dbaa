"""Design-space exploration on the PyTorch port: 64 SoC designs × 4 traces
in one epoch scan.

The twin of ``examples/dse_pareto.py``.  Sweeps a latin-hypercube sample of
the big/LITTLE/accelerator design space under a WiFi TX+RX workload
declared by one ``Scenario``, on the card by default (``--device cpu`` runs
the scan's plain version), prints the non-dominated (latency, energy,
peak-temperature) front, then spot-checks three designs of the padded
sweep against per-point ``run(..., backend="torch")``: the makespan bit for
bit, latency, energy and per-PE busy time within 1e-6 relative (sums taken
in another order).

    PYTHONPATH=src python examples/dse_pareto_torch.py [--device cpu]
"""
import argparse
import importlib
import time

import numpy as np

from repro_torch.dse import DesignSpace, evaluate, format_front
from repro_torch.scenario import Scenario, TraceSpec, run, sweep

# the module (the package's `sweep` attribute is the function)
sweep_mod = importlib.import_module("repro_torch.scenario.sweep")

NUM_DESIGNS = 64
NUM_TRACES = 4
NUM_JOBS = 32
RATE = 20.0          # jobs/ms
POLICY = "etf"

BASE = Scenario(apps=("wifi_tx", "wifi_rx"), scheduler=POLICY,
                governor="design",
                trace=TraceSpec(rate_jobs_per_ms=RATE, num_jobs=NUM_JOBS))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain scan)")
    device = ap.parse_args(argv).device

    points = DesignSpace().sample_lhs(NUM_DESIGNS, seed=0)
    seeds = list(range(NUM_TRACES))
    traces = [BASE.with_seed(s).job_trace() for s in seeds]

    t0 = time.perf_counter()
    result = evaluate(points, BASE.applications(), traces, policy=POLICY,
                      device=device)
    dt = time.perf_counter() - t0
    print(format_front(result))
    print(f"{NUM_DESIGNS} designs x {NUM_TRACES} traces "
          f"({NUM_DESIGNS * NUM_TRACES} simulations) in {dt:.2f}s "
          f"(incl. kernel build)\n")

    # -- padded-sweep vs per-point run() spot check ------------------------
    n0 = sum(sweep_mod.scan_calls.values())
    sr = sweep(BASE, axes={"design": points, "seed": seeds}, device=device)
    print(f"sweep over design x seed: shape {sr.shape}, "
          f"{sum(sweep_mod.scan_calls.values()) - n0} epoch scan(s)")
    rng = np.random.default_rng(1)
    for d in rng.choice(NUM_DESIGNS, size=3, replace=False):
        p = points[d]
        for s in seeds:
            ref = run(BASE.replace(design=p).with_seed(s), device=device)
            assert sr.makespan_us[d, s] == ref.makespan_us, p.label()
            np.testing.assert_allclose(
                [sr.avg_latency_us[d, s], sr.energy_j[d, s]],
                [ref.avg_latency_us, ref.energy_j], rtol=1e-6, atol=0,
                err_msg=p.label())
            np.testing.assert_allclose(
                sr.utilization[d, s, :p.num_pes], ref.utilization,
                rtol=1e-6, atol=1e-12, err_msg=p.label())
        print(f"spot-check {p.label():>26}: padded sweep == per-point "
              f"run(backend='torch') (makespan bit for bit, sums 1e-6)")


if __name__ == "__main__":
    main()
