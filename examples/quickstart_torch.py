"""Quickstart on the PyTorch port: the paper in 60 seconds, through
``repro_torch``'s Scenario API.

The twin of ``examples/quickstart.py``.  One declarative ``Scenario`` wires
SoC, workload, scheduler and governor; ``sweep()`` cross-products axes and
``run()`` simulates one point, both through the epoch scan on the card by
default (``--device cpu`` runs its plain version).  Prints the Fig-3 sweep,
an ASCII Gantt chart (from the event-heap oracle, ``backend="ref"``, whose
result carries the task records) and energy numbers.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import reports
from repro_torch.scenario import Scenario, TraceSpec, run, sweep

BASE = Scenario(apps=("wifi_tx",))
RATES = [1, 10, 20, 40, 60, 80]
SEEDS = [0, 1, 2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain scan)")
    device = ap.parse_args(argv).device

    db = BASE.soc()
    table = BASE.replace(scheduler="table").schedule_table()
    print("ILP-optimal single-job table:",
          {t: db.pes[pe].name for (_, t), pe in sorted(table.items())}, "\n")

    # one sweep, one epoch scan per scheduler value
    sr = sweep(BASE, axes={"scheduler": ["met", "etf", "table"],
                           "rate": RATES, "seed": SEEDS}, device=device)
    curves = dict(zip(["met", "etf", "table"],
                      sr.avg_latency_us.mean(axis=2)))
    print(f"{'rate (jobs/ms)':>15} {'MET':>9} {'ETF':>9} {'ILP':>9}   (avg job latency, us)")
    for i, rate in enumerate(RATES):
        print(f"{rate:>15} {curves['met'][i]:>9.1f} {curves['etf'][i]:>9.1f} "
              f"{curves['table'][i]:>9.1f}")

    print("\nSchedule (ETF, first jobs) — one row per PE, digits = job id:")
    res = run(BASE.replace(trace=TraceSpec(rate_jobs_per_ms=30, num_jobs=12)),
              backend="ref")
    print(reports.gantt_ascii(db, res.raw, width=90))

    for gov in ["performance", "powersave", "ondemand"]:
        res = run(BASE.replace(governor=gov,
                               trace=TraceSpec(rate_jobs_per_ms=20,
                                               num_jobs=100)),
                  device=device)
        print(f"governor={gov:<12} latency={res.avg_latency_us:7.1f}us "
              f"energy={res.energy_j:8.5f}J "
              f"avg_power={res.avg_power_w:5.2f}W "
              f"T_steady_peak={res.peak_temp_c:5.1f}C")


if __name__ == "__main__":
    main()
