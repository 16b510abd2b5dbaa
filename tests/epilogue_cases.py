"""Schedules for the epilogue's tests (tests/test_torch_epilogue*.py) and
chip_smoke.py: K1's outputs (its plain version on the CPU) on the DS3 apps,
static and DTPM, with fail-stop lanes, over stacked designs whose PEs are
padded to 19 and 32, and at J·T no power of two.

``case(name, device)`` -> ``(tables, arrival, app_idx, schedule)``, the
schedule ``(scheduled, start, finish, onpe[, onopp])`` as ``_epilogue``
takes it.  ``with_nan`` writes NaN into the start and finish of every cell
that is not valid, as a kernel that left them unwritten might hold.
``synthetic`` draws schedules of any size without a scan (the epilogue
reads no more than a schedule's shape and its valid cells).
"""
import numpy as np
import torch

from repro_torch.core import (OndemandGovernor, build_tables,
                              get_application, make_soc_table2,
                              poisson_trace)
from repro_torch.core.dvfs import policy_lanes
from repro_torch.dse import DesignPoint, build_design_batch
from repro_torch.kernels import epoch_scan as k1

APPS = ("wifi_tx", "wifi_rx")
# designs of 5, 14 and 19 PEs, padded to 19 or 32 (two slot widths of K7)
POINTS = (DesignPoint(num_big=1, num_little=1, num_scr=1, num_fft=1,
                      num_vit=1),
          DesignPoint(),
          DesignPoint(num_big=4, num_little=4, num_scr=3, num_fft=6,
                      num_vit=2))

# name -> (jobs, rates, seeds, dtpm, faults, designs' PE padding or None)
CASES = {
    "static": (45, (5.0, 30.0), (0, 1), False, False, None),
    "dtpm": (45, (5.0, 30.0), (0, 1), True, False, None),
    "faults": (40, (20.0,), (0, 1, 2), False, True, None),
    "faults_dtpm": (40, (20.0,), (0, 1, 2), True, True, None),
    "stacked_19": (30, (10.0,), (0, 1), False, False, 19),
    "stacked_32_dtpm": (30, (10.0,), (0, 1), True, False, 32),
    "one_lane": (37, (25.0,), (3,), False, False, None),
}


def lanes(jobs, rates, seeds):
    """(L, J) arrival f32 and app index i32 of Poisson traces."""
    traces = [poisson_trace(r, jobs, list(APPS), seed=s)
              for r in rates for s in seeds]
    return (np.stack([t.arrival_us for t in traces]).astype(np.float32),
            np.stack([t.app_index for t in traces]).astype(np.int32))


def case(name, device):
    jobs, rates, seeds, dtpm, faults, pad = CASES[name]
    apps = [get_application(n) for n in APPS]
    gov = OndemandGovernor() if dtpm else None
    arr, idx = lanes(jobs, rates, seeds)
    if pad is None:
        tables = build_tables(make_soc_table2(), apps, governor=gov,
                              device=device)
        D = 1
    else:
        tables = build_design_batch(list(POINTS), apps, pad_pes=pad,
                                    governor=gov, device=device).tables
        D = len(POINTS)
        arr, idx = np.tile(arr, (D, 1)), np.tile(idx, (D, 1))
    L = arr.shape[0]
    arrival = torch.from_numpy(arr).to(device)
    app_idx = torch.from_numpy(idx).to(device)
    plans = None
    if faults:       # lane k loses PE k - 1 at its job 10's arrival (lane 0: none)
        plans = torch.full((L, tables.num_pes), float("inf"))
        for k in range(1, L):
            plans[k, k - 1] = float(arr[k, 10])
        plans = plans.to(device)
    lanes_gov = policy_lanes(gov.policy(), L) if dtpm else None
    out = k1.epoch_scan(tables, "etf", arrival, app_idx, gov=lanes_gov,
                        faults=plans)
    schedule = tuple(out[:5] if dtpm else out[:4])
    assert D == max(k1.designs(tables), 1)
    return tables, arrival, app_idx, schedule


def with_nan(tables, app_idx, schedule):
    """The schedule with NaN in the start and finish of its invalid cells
    (the tasks a lane's app does not have)."""
    design = k1.lane_designs(tables, app_idx.shape[0], app_idx.device)
    bad = ~k1.per_design(tables, "valid")[design[:, None], app_idx.long()]
    assert bool(bad.any())
    scheduled, start, finish, *rest = schedule
    nan = torch.tensor(float("nan"), device=start.device)
    return (scheduled, torch.where(bad, nan, start),
            torch.where(bad, nan, finish), *rest)


def synthetic(gen, tables, L, J, dtpm=False):
    """Random lanes and schedules of L lanes x J jobs on ``tables`` (drawn on
    ``gen``'s device): arrivals over 2 s, tasks of 1-61 us on any PE at any
    OPP, finish >= start; the cells that are not valid hold NaN."""
    dev = gen.device
    A, T = k1.per_design(tables, "valid").shape[1:]
    P = tables.num_pes
    arrival = torch.sort(torch.rand((L, J), generator=gen, device=dev)
                         * 2e6, dim=1).values
    app_idx = torch.randint(0, A, (L, J), generator=gen, device=dev,
                            dtype=torch.int32)
    start = arrival[..., None] + torch.rand((L, J, T), generator=gen,
                                            device=dev) * 500.0
    finish = start + 1.0 + torch.rand((L, J, T), generator=gen,
                                      device=dev) * 60.0
    onpe = torch.randint(0, P, (L, J, T), generator=gen, device=dev,
                         dtype=torch.int32)
    scheduled = torch.ones((L, J, T), dtype=torch.bool, device=dev)
    schedule = (scheduled, start, finish, onpe)
    if dtpm:
        K = tables.power_active_opp.shape[-1]
        schedule += (torch.randint(0, K, (L, J, T), generator=gen,
                                   device=dev, dtype=torch.int32),)
    return arrival, app_idx, with_nan(tables, app_idx, schedule)
