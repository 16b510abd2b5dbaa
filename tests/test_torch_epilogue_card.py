"""K7, the epilogue kernel (``csrc/epilogue.cu``), on the card.

Against the plain version (``epilogue_plain``) on the card bit for bit in
every output, and on the CPU too but for the latency's last division (one
ulp: PyTorch multiplies a CUDA tensor by the reciprocal of a scalar
divisor).  On K1's schedules (tests/epilogue_cases.py: static, DTPM with
the latched OPPs, fail-stop lanes, stacked designs with padded PEs, J·T no
power of two, one lane), each also with NaN in the cells that are not
valid; on random schedules at each of the kernel's three slot widths (up
to 79 PEs) and at the seconds cell's J (40,000 jobs: stack levels past
shared memory).  A lane alone equals the same lane in its batch; every grid
scan of a sweep launches K7 once; the shapes it cannot take raise before a
launch; a PE index out of range on a valid cell traps.

Imports torch and the port only, so that it runs on the card's machine:
``python -m pytest -m card tests/test_torch_epilogue_card.py``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from epilogue_cases import CASES, POINTS, case, synthetic, with_nan
from repro_torch.core import (OndemandGovernor, build_tables,
                              get_application, make_soc_table2)
from repro_torch.core.simkernel_torch import ARRAY_FIELDS
from repro_torch.dse import build_design_batch
from repro_torch.kernels import epilogue as k7
from repro_torch.kernels import epoch_scan as k1
from repro_torch.obs import metrics

ROOT = Path(__file__).resolve().parents[1]
OUTPUTS = ("job_finish", "makespan_us", "avg_job_latency_us", "energy_j",
           "busy_per_pe_us")


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 launches only on a card")
    return torch.device("cuda")


def on(tables, device):
    """A table set's fields on ``device``."""
    return dataclasses.replace(tables, device=torch.device(device), **{
        name: getattr(tables, name).to(device) for name in ARRAY_FIELDS
        if getattr(tables, name) is not None})


def design(tables, d):
    """Design d of a stack as a stack of one (one design's tables as they
    are)."""
    if not k1.designs(tables):
        return tables
    return dataclasses.replace(tables, **{
        name: getattr(tables, name)[d:d + 1] for name in ARRAY_FIELDS
        if getattr(tables, name) is not None})


def assert_same_bits(got, want, what, latency_ulps=0):
    """Every output the same bits; ``latency_ulps``: the latency within that
    many units in the last place."""
    for key in OUTPUTS:
        g, w = got[key].cpu(), want[key].cpu()
        assert g.dtype == w.dtype == torch.float32, (what, key)
        assert g.shape == w.shape, (what, key)
        if key == "avg_job_latency_us" and latency_ulps:
            gap = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(gap.abs().max()) <= latency_ulps, (what, key)
            continue
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
            (what, key, int((g != w).sum()))


def check(tables, arrival, app_idx, schedule, what, against_cpu=True):
    """K7 against the plain version on the card (and on the CPU); one
    launch; returns the kernel's outputs."""
    launches = metrics.counter(k7.LAUNCHES)
    before = launches.value
    got = k7.epilogue(tables, arrival, app_idx, *schedule)
    assert launches.value == before + 1
    for key, x in zip(("scheduled", "start", "finish", "onpe"), schedule):
        assert got[key] is x
    assert_same_bits(got, k7.epilogue_plain(tables, arrival, app_idx,
                                            *schedule), what)
    if against_cpu:
        # the CPU's eager latency divides by J where a CUDA tensor's is
        # multiplied by 1/J: one ulp apart at most; the sums are the same
        cpu = [x.cpu() for x in (arrival, app_idx, *schedule)]
        assert_same_bits(got, k7.epilogue_plain(on(tables, "cpu"), *cpu),
                         what + " (CPU)", latency_ulps=1)
    return got


@pytest.mark.card
@pytest.mark.parametrize("nan", [False, True], ids=["as_scanned", "nan"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_on_k1_schedules(name, nan):
    dev = card()
    tables, arrival, app_idx, schedule = case(name, dev)
    if nan:
        schedule = with_nan(tables, app_idx, schedule)
    got = check(tables, arrival, app_idx, schedule, name)
    # a lane alone, with its design alone: the bits it has in the batch
    L = arrival.shape[0]
    S = k1.lanes_per_design(tables, L)
    for lane in sorted({0, L // 2, L - 1}):
        one = k7.epilogue(design(tables, lane // S), arrival[lane:lane + 1],
                          app_idx[lane:lane + 1],
                          *[x[lane:lane + 1] for x in schedule])
        for key in OUTPUTS:
            assert torch.equal(one[key][0], got[key][lane]), (name, lane, key)


def padded_tables(P, dtpm, device):
    """Five-app tables of the Table-2 SoC (one design) or of POINTS padded
    to P PEs (a stack of three)."""
    apps = [get_application(n) for n in
            ("wifi_tx", "wifi_rx", "range_detection", "single_carrier",
             "pulse_doppler")]
    gov = OndemandGovernor() if dtpm else None
    if P is None:
        return build_tables(make_soc_table2(), apps, governor=gov,
                            device=device)
    return build_design_batch(list(POINTS), apps, pad_pes=P, governor=gov,
                              device=device).tables


@pytest.mark.card
@pytest.mark.parametrize("dtpm", [False, True], ids=["static", "dtpm"])
@pytest.mark.parametrize("P,L,J", [(None, 1, 1), (None, 5, 3),
                                   (None, 7, 1000), (19, 6, 777),
                                   (31, 3, 64), (32, 6, 500), (64, 3, 300),
                                   (79, 3, 33)],
                         ids=lambda v: str(v))
def test_kernel_equals_plain_at_every_slot_width(P, L, J, dtpm):
    dev = card()
    tables = padded_tables(P, dtpm, dev)
    gen = torch.Generator(dev).manual_seed(J * 100 + L)
    arrival, app_idx, schedule = synthetic(gen, tables, L, J, dtpm)
    check(tables, arrival, app_idx, schedule, f"P={P} L={L} J={J}")


@pytest.mark.card
def test_kernel_equals_plain_at_the_seconds_cells_length():
    """40,000 jobs of 8 tasks a lane (the dtpm-seconds-sweep cell's J, a
    stack of 12 levels) on 64 lanes, DTPM."""
    dev = card()
    tables = padded_tables(None, True, dev)
    gen = torch.Generator(dev).manual_seed(40_000)
    arrival, app_idx, schedule = synthetic(gen, tables, 64, 40_000, True)
    check(tables, arrival, app_idx, schedule, "seconds", against_cpu=False)


@pytest.mark.card
def test_every_grid_scan_launches_the_kernel_once():
    """A static sweep over two schedulers: one K7 launch a scheduler (and
    one a shard under ``sweep(shard=)``); a DTPM sweep: one; the lanes the
    bits of ``run``."""
    card()
    from repro_torch.dse import DesignPoint
    from repro_torch.scenario import Scenario, TraceSpec, run, sweep
    from repro_torch.sharding import virtual_lane_devices
    scn = Scenario(apps=("wifi_tx", "wifi_rx"), scheduler="etf",
                   governor="design",
                   trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=120,
                                   seed=1))
    points = [DesignPoint(cross_cluster_penalty=1.0 + 0.25 * i)
              for i in range(6)]
    axes = {"design": points, "scheduler": ["etf", "met"], "seed": [0, 1]}
    launches = metrics.counter(k7.LAUNCHES)
    before = launches.value
    whole = sweep(scn, axes, shard=False)
    assert launches.value == before + 2
    for i, j, k in ((0, 0, 0), (3, 1, 1), (5, 0, 1)):
        one = run(scn.replace(design=points[i],
                              scheduler=axes["scheduler"][j]).with_seed(
                                  axes["seed"][k]))
        assert np.float64(np.float32(one.avg_latency_us)) == \
            whole.avg_latency_us[i, j, k]
        assert np.float64(np.float32(one.energy_j)) == whole.energy_j[i, j, k]
    before = launches.value
    with virtual_lane_devices(4):
        sharded = sweep(scn, axes)
    assert launches.value == before + 2 * 4
    assert np.array_equal(sharded.energy_j, whole.energy_j)
    before = launches.value
    dtpm = Scenario(apps=("wifi_tx",), scheduler="etf", governor="ondemand",
                    trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=60,
                                    seed=2))
    sweep(dtpm, {"seed": [0, 1, 2]}, shard=False)
    assert launches.value == before + 1


@pytest.mark.card
def test_kernel_geometry_and_refusals():
    dev = card()
    info = k7.kernel_info(40_000, 8, 5, 15, 5, dev)
    print("K7 at the seconds cell's shape:", info)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 8
    assert info["slots"] == 16 and info["threads"] == 96
    before = metrics.counter(k7.LAUNCHES).value
    gen = torch.Generator(dev).manual_seed(3)
    tables = padded_tables(80, False, dev)
    arrival, app_idx, schedule = synthetic(gen, tables, 3, 5)
    with pytest.raises(ValueError, match="1..79 PEs"):
        k7.epilogue(tables, arrival, app_idx, *schedule)
    tables = padded_tables(None, False, dev)
    arrival, app_idx, schedule = synthetic(gen, tables, 2, 5)
    start = schedule[1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        k7.epilogue(tables, arrival, app_idx, schedule[0], start,
                    *schedule[2:])
    with pytest.raises(ValueError, match="do not split evenly"):
        k7.epilogue(padded_tables(19, False, dev), arrival, app_idx,
                    *schedule)
    assert metrics.counter(k7.LAUNCHES).value == before


BAD_INDEX = textwrap.dedent("""
    import sys
    import torch
    from epilogue_cases import case
    from repro_torch.kernels import epilogue as k7
    tables, arrival, app_idx, schedule = case("static", "cuda")
    k7.epilogue(tables, arrival, app_idx, *schedule)
    torch.cuda.synchronize()
    onpe = schedule[3].clone()
    onpe[1, 2, 0] = tables.num_pes           # job 2's first task is valid
    try:
        k7.epilogue(tables, arrival, app_idx, *schedule[:3], onpe)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("refused:", e)
        sys.exit(0 if "CUDA error" in str(e) else 1)
    sys.exit(1)
""")


@pytest.mark.card
def test_kernel_traps_on_a_pe_out_of_range():
    """A valid cell's PE index past P traps (after a launch on good indices
    passes), which leaves the process's CUDA context unusable, so in a
    process of its own."""
    card()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", BAD_INDEX], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
