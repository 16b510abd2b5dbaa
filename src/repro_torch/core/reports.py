"""Reporting: schedule tables + performance/throughput/energy summaries.

The twin of ``src/repro/core/reports.py`` (numpy only), over the port's
``simkernel_ref.SimResult`` and ``ResourceDB``.  The paper: "the framework
generates plots and reports of schedule, performance, throughput, and
energy consumption".  Headless environment ⇒ ASCII Gantt + CSV emitters.
"""
from __future__ import annotations

import io
from typing import List, Optional, Sequence

import numpy as np

from .resources import ResourceDB
from .simkernel_ref import SimResult


def schedule_table(db: ResourceDB, result: SimResult, max_rows: int = 40) -> str:
    out = io.StringIO()
    out.write(f"{'job':>4} {'task':>4} {'pe':>8} {'ready':>10} {'start':>10} "
              f"{'finish':>10} {'f(GHz)':>7}\n")
    for r in result.records[:max_rows]:
        out.write(f"{r.job_id:>4} {r.task_id:>4} {db.pes[r.pe_id].name:>8} "
                  f"{r.ready_us:>10.2f} {r.start_us:>10.2f} {r.finish_us:>10.2f} "
                  f"{r.freq_ghz:>7.2f}\n")
    if len(result.records) > max_rows:
        out.write(f"... ({len(result.records) - max_rows} more rows)\n")
    return out.getvalue()


def gantt_ascii(db: ResourceDB, result: SimResult, width: int = 100,
                t_end_us: Optional[float] = None) -> str:
    """ASCII Gantt chart of the realised schedule (one row per PE)."""
    t_end = t_end_us or result.makespan_us
    if t_end <= 0:
        return "(empty schedule)\n"
    scale = width / t_end
    rows = {pe.pe_id: [" "] * width for pe in db.pes}
    for r in result.records:
        a = int(r.start_us * scale)
        b = max(a + 1, int(r.finish_us * scale))
        ch = str(r.job_id % 10)
        for k in range(a, min(b, width)):
            rows[r.pe_id][k] = ch
    out = io.StringIO()
    for pe in db.pes:
        out.write(f"{pe.name:>8} |{''.join(rows[pe.pe_id])}|\n")
    out.write(f"{'':>8}  0{'':{width - 12}}{t_end:.0f} us\n")
    return out.getvalue()


def summary_csv(rows: Sequence[dict]) -> str:
    """Rows of {scheduler, rate, avg_latency_us, throughput, energy_j} -> CSV."""
    if not rows:
        return ""
    keys = list(rows[0].keys())
    out = io.StringIO()
    out.write(",".join(keys) + "\n")
    for r in rows:
        out.write(",".join(f"{r[k]:.4f}" if isinstance(r[k], float) else str(r[k])
                           for k in keys) + "\n")
    return out.getvalue()


def summarize(db: ResourceDB, result: SimResult, scheduler: str, rate: float) -> dict:
    return dict(
        scheduler=scheduler,
        rate_jobs_per_ms=float(rate),
        num_jobs=len(result.job_finish_us),
        avg_job_latency_us=result.avg_job_latency_us,
        throughput_jobs_per_ms=result.throughput_jobs_per_ms,
        makespan_us=result.makespan_us,
        energy_j=result.energy.total_energy_j,
        avg_power_w=result.energy.avg_power_w,
    )
