"""DS3 core on PyTorch — the simulator of the paper's DSSoC framework.

    resources:       PE, ResourceDB, CommModel, make_soc_table2, make_soc
    applications:    Application, Task, get_application, REFERENCE_APPS
    jobgen:          JobTrace, poisson_trace, deterministic_trace, rate_sweep
    schedulers:      get_scheduler, register_scheduler, solve_optimal_table
    simkernel_ref:   the event-heap reference kernel (``simulate``)
    simkernel_torch: build_tables + simulate_torch / simulate_batch (the
                     epoch scan; K1 on a CUDA device)
    power/thermal/dvfs: analytical models + governors
    reports:         schedule tables, ASCII Gantt, summary CSV

Prefer ``repro_torch.scenario``: one declarative ``Scenario`` plus ``run()``.
"""
from .applications import (Application, REFERENCE_APPS, Task, get_application,
                           pulse_doppler, range_detection, single_carrier,
                           wifi_rx, wifi_tx)
from .dvfs import (GOVERNORS, Governor, GovernorPolicy, OndemandGovernor,
                   PerformanceGovernor, PowersaveGovernor, ThrottleGovernor,
                   UserspaceGovernor, get_governor, ondemand_index,
                   throttle_index)
from .jobgen import JobTrace, deterministic_trace, poisson_trace, rate_sweep
from .power import EnergyReport, active_power, energy_from_schedule, idle_power
from .resources import (ACC_FFT, ACC_SCRAMBLER, ACC_VITERBI, CPU_BIG,
                        CPU_LITTLE, CommModel, PE, ResourceDB, make_soc,
                        make_soc_table2)
from .schedulers import (ETFScheduler, METScheduler, SchedContext, Scheduler,
                         TableScheduler, available_schedulers, get_scheduler,
                         register_scheduler, solve_optimal_table)
from .simkernel_ref import SimResult, TaskRecord
from .simkernel_torch import (SimTables, build_tables, simulate_batch,
                              simulate_torch, tables_from_numpy)
from . import reports, simkernel_ref, simkernel_torch, thermal

__all__ = [n for n in dir() if not n.startswith("_")]
