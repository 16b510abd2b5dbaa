"""K1 (``csrc/epoch_scan.cuh``) past its old job cap and on overloaded lanes,
on the card.

The fault-free programs keep only the live window (the first job with a
task left to the first job with none placed) in a ring of at most 1,024
slots, so J no longer bounds a launch; a lane whose backlog outgrows the
ring runs again with its job state in a global buffer; a static lane whose
ring has a slot for every job takes them all at the start.  Against
``epoch_scan_plain`` on the card, bit for bit: 20,000 jobs a lane (past the
old shared-memory caps, ~18,580 static and ~14,560-17,100 DTPM at the
Table-2 SoC), static and DTPM; two PEs at 80 jobs/ms, whose backlog spills
(the lanes counted by ``k1_overflow_lanes``); the four programs at 1,000
jobs, the fail-stop ones with PEs lost mid-run.  The most jobs each lane
held, K1's ``live`` output, equals ``kernel_live`` (tests/k1_window.py)
read off the plain outputs.  Arrivals that fall within a lane trap.  The
shared bytes of a block are the same at 1,000 and at 40,000 jobs.

Imports torch and the port only, so that it runs on the card's machine:
``python -m pytest -m card tests/test_torch_epoch_scan_long_card.py``
(~9 minutes: the plain version takes ~1 ms a step on the card).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.dvfs import policy_lanes
from repro_torch.core.jobgen import poisson_trace
from repro_torch.dse import DesignPoint
from repro_torch.kernels import epoch_scan as k1
from repro_torch.obs import metrics
from repro_torch.scenario import Scenario, tables_for

from k1_window import kernel_live

ROOT = Path(__file__).resolve().parents[1]

APPS = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
        "pulse_doppler")
TABLE2 = DesignPoint(num_vit=1)                     # 15 PEs
TWO_PES = DesignPoint(num_big=1, num_little=1, num_scr=0, num_fft=0)


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 launches only on a card")
    return torch.device("cuda")


def lanes(rates, jobs, dev, seed=0):
    traces = [poisson_trace(r, jobs, APPS, seed=seed + k)
              for k, r in enumerate(rates)]
    return (torch.from_numpy(np.stack([t.arrival_us for t in traces])).to(dev),
            torch.from_numpy(np.stack([t.app_index for t in traces])).to(dev))


def program(dev, design, policy, governor, L):
    scn = Scenario(design=design, apps=APPS, scheduler=policy,
                   governor=governor)
    tables = tables_for(scn, device=dev)
    gov = policy_lanes(scn.make_policy(), L) if governor == "ondemand" else None
    return tables, gov


def scan(tables, policy, arrival, app_idx, gov=None, faults=None):
    """K1 under a profiler, so that it hands over its per-lane ``live``
    output; the kernel's outputs, bit for bit the plain version's, and the
    most jobs each lane held, equal to ``kernel_live``."""
    held = []
    real = metrics.k1_live
    metrics.k1_live = lambda live, slots: held.append(live.cpu())
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = k1.epoch_scan(tables, policy, arrival, app_idx, gov, faults)
            torch.cuda.synchronize()
    finally:
        metrics.k1_live = real
    want = k1.epoch_scan_plain(tables, policy, arrival, app_idx, gov, faults)
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"output {n} differs"
    live = kernel_live(tables, arrival, app_idx, want[0], want[2],
                       faults is not None, gov is not None).cpu()
    assert torch.equal(held[0], live), (held[0].tolist(), live.tolist())
    return live


@pytest.mark.card
@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_past_the_old_cap_bit_for_bit(governor):
    dev = card()
    J = 20_000                  # every job in shared memory took 12 bytes
    assert 12 * J > k1.MAX_SHARED
    tables, gov = program(dev, TABLE2, "etf", governor, 2)
    arrival, app_idx = lanes((20.0, 20.0), J, dev)
    live = scan(tables, "etf", arrival, app_idx, gov)
    assert int(live.max()) <= k1.job_slots(J)      # a light load: no spill


@pytest.mark.card
@pytest.mark.parametrize("governor", ["performance", "ondemand"])
def test_an_overloaded_lane_spills_bit_for_bit(governor):
    dev = card()
    J = 2_000
    tables, gov = program(dev, TWO_PES, "etf", governor, 2)
    arrival, app_idx = lanes((80.0, 80.0), J, dev, seed=7)
    before = metrics.run_manifest()[metrics.K1_OVERFLOW]
    with profile(activities=[ProfilerActivity.CPU]):
        k1.epoch_scan(tables, "etf", arrival, app_idx, gov)
    # read in the manifest, after a synchronise of the card
    man = metrics.run_manifest(device=dev)
    assert man[metrics.K1_OVERFLOW] == before + 2
    assert man[metrics.K1_LIVE_PEAK] > k1.job_slots(J)
    live = scan(tables, "etf", arrival, app_idx, gov)
    assert int(live.min()) > k1.job_slots(J)       # both lanes spilled


def fault_plans(L, P, dev):
    """Four PEs lost at 200-900 us (mid-run), none on lane 0."""
    plans = torch.full((L, P), float("inf"))
    for l in range(1, L):
        for pe, t_us in ((0, 200.0 * l), (4, 350.0), (9, 900.0), (14, 500.0)):
            plans[l, pe] = t_us
    return plans.to(dev)


@pytest.mark.card
@pytest.mark.parametrize("governor,policy,faults", [
    ("performance", "etf", False), ("performance", "met", False),
    ("performance", "table", False), ("ondemand", "etf", False),
    ("ondemand", "met", False), ("performance", "etf", True),
    ("performance", "met", True), ("ondemand", "met", True)])
def test_the_four_programs_at_1000_jobs(governor, policy, faults):
    """Rates up to 80 jobs/ms: MET's and the table's backlogs there reach
    ~800 of the 1,000 jobs, inside the ring of 1,024; a static or fail-stop
    lane takes all 1,000 at the start (``live`` 1,000), a DTPM one keeps
    its window."""
    dev = card()
    rates = (5.0, 20.0, 60.0, 80.0)
    tables, gov = program(dev, TABLE2, policy, governor, len(rates))
    arrival, app_idx = lanes(rates, 1000, dev, seed=3)
    plans = fault_plans(len(rates), tables.num_pes, dev) if faults else None
    live = scan(tables, policy, arrival, app_idx, gov, plans)
    if gov is None or faults:
        assert live.tolist() == [1000] * len(rates)
    else:
        assert int(live.max()) <= 1000


@pytest.mark.card
def test_shared_bytes_do_not_grow_with_jobs():
    dev = card()
    tables, _ = program(dev, TABLE2, "etf", "ondemand", 1)
    C, K = tables.opp_freq.shape[-2:]
    for CK in ((0, 0), (C, K)):
        # every job at the start, and the live window: two instantiations
        short = k1.kernel_info(1000, 5, 8, 15, dev, *CK)
        long = k1.kernel_info(40_000, 5, 8, 15, dev, *CK)
        assert short["shared_bytes"] == long["shared_bytes"]
        for info in (short, long):
            # a wave of 1,024 lanes on the card's 132 SMs, as before the ring
            assert info["lanes_per_sm"] >= (8 if CK[1] else 12), info
            assert info["local_bytes"] == 0, info


FALLING = textwrap.dedent("""
    import sys
    import torch
    from test_torch_epoch_scan_long_card import TABLE2, lanes, program
    from repro_torch.kernels import epoch_scan as k1
    J, governor = int(sys.argv[1]), sys.argv[2]
    dev = torch.device("cuda")
    tables, gov = program(dev, TABLE2, "etf", governor, 2)
    arrival, app_idx = lanes((20.0, 20.0), J, dev)
    k1.epoch_scan(tables, "etf", arrival, app_idx, gov)
    torch.cuda.synchronize()            # sorted: runs
    arrival[1, J - 40] = arrival[1, J - 41] - 1.0
    try:
        k1.epoch_scan(tables, "etf", arrival, app_idx, gov)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("refused:", e)
        sys.exit(0 if "CUDA error" in str(e) else 1)
    sys.exit(1)
""")


@pytest.mark.card
@pytest.mark.parametrize("J,governor", [(1000, "performance"),
                                        (2000, "ondemand")])
def test_falling_arrivals_trap(J, governor):
    """An arrival below the one before it in its lane: the fault-free
    programs trap where they take that job (the window's pick is exact only
    where arrivals ascend), whether the lane takes every job at the start
    (static, 1,000) or a window at a time (DTPM, 2,000).  A trap leaves the process's
    CUDA context unusable, so in a process of its own."""
    card()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", FALLING, str(J), governor],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
