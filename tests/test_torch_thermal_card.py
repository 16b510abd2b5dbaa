"""K6, the thermal grid kernel (``csrc/thermal_grid.cu``), on the card.

Against ``peak_temperature_grid_plain`` on the CPU and on the card's eager
ops at ``RTOL`` (peak temperature; exp, the busy sums and the RC products
round in other orders), over bin counts past one warp's 32 and PE counts up
to the kernel's 32, with a leading fault axis, an all-unscheduled lane, a
zero makespan, bins that the PEs fill in part, a period that heats and cools
(tests/thermal_schedules.py's ``BIN_CASES``, at DS3's 1,000 jobs x 8
tasks), and the benchmark's shapes (3,072 lanes at 15 PEs; 1,080 padded
designs of up to 19 PEs x 4 lanes).  The plain version equals
``repro.dse.thermal_jax`` on the CPU (tests/test_torch_thermal_grid.py).
A lane's bits depend on its inputs alone: alone, inside the grid, through
``run`` and under ``sweep(shard=)``.  A PE or node index out of range traps,
as the plain version's one-hot fails a device-side assert on the card.

Imports torch and the port only, so that it runs on the card's machine:
``python -m pytest -m card tests/test_torch_thermal_card.py``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dse import thermal_torch as tthermal
from repro_torch.obs import metrics
from thermal_schedules import (BIN_CASES, BIN_PES, assert_bins_matter,
                               schedules)

ROOT = Path(__file__).resolve().parents[1]


# A bin's RC step is close to the identity (lambda * dt ~ 1e-4 .. 1e-2), so
# one ulp of one exp moves a peak by up to 1.2e-5 relative, and the plain
# version itself, run on the CPU and on the card (the CPU's and CUDA's exp,
# the CPU's and cuBLAS's sums), differs by up to 1.5e-5 at these shapes.
RTOL = 2e-5


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 launches only on a card")
    return torch.device("cuda")


def cpu(x):
    return {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) \
        else x.cpu()


def check(out, tables, bins, repeats, against_cpu=True):
    """The kernel against the plain version on the card (and on the CPU);
    returns the kernel's peaks."""
    before = metrics.counter("thermal_launches").value
    got = tthermal.peak_temperature_grid(out, *tables, bins=bins,
                                         repeats=repeats)
    assert metrics.counter("thermal_launches").value == before + 1
    want = tthermal.peak_temperature_grid_plain(out, *tables, bins, repeats)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL)
    if against_cpu:
        want = tthermal.peak_temperature_grid_plain(
            cpu(out), *map(cpu, tables), bins, repeats)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=RTOL)
    return got


@pytest.mark.card
@pytest.mark.parametrize("bins", [1, 12, 32, 40])
@pytest.mark.parametrize("P", [7, 15, 19, 32])
def test_kernel_equals_plain_with_a_fault_axis(bins, P):
    dev = card()
    gen = torch.Generator(dev).manual_seed(bins * 100 + P)
    pes = [P, max(1, P - 3), max(1, P // 2)]
    out, *tables = schedules(gen, (2, 3, 4), 40, 6, pes)
    got = check(out, tables, bins, 3)
    assert got.shape == (2, 3, 4)


@pytest.mark.card
def test_kernel_unscheduled_lane_zero_makespan_and_no_steps():
    dev = card()
    gen = torch.Generator(dev).manual_seed(7)
    out, *tables = schedules(gen, (2, 3), 30, 5, [9, 4])
    out["scheduled"][1, 2] = False
    out["makespan_us"][1, 2] = 0.0
    out["makespan_us"][0, 0] = 0.0          # busy cells, zero makespan
    check(out, tables, 12, 3)
    check(out, tables, 40, 0)               # the steady state alone


@pytest.mark.card
@pytest.mark.parametrize("case", list(BIN_CASES))
def test_kernel_equals_plain_where_bins_matter(case):
    """Bins filled in part (every busy sum counts) and a period that heats
    and cools (every bin's step counts): first that the case does so, by
    the plain version, then the kernel against it."""
    dev = card()
    gen = torch.Generator(dev).manual_seed(17)
    out, *tables = schedules(gen, (2, len(BIN_PES), 16), pes=BIN_PES,
                             **BIN_CASES[case][1])
    want = tthermal.peak_temperature_grid_plain(out, *tables, 32, 3)
    assert_bins_matter(out, tables, 32, want, case, RTOL)
    check(out, tables, 32, 3)


BAD_INDEX = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.dse import thermal_torch as tthermal
    from thermal_schedules import schedules
    gen = torch.Generator("cuda").manual_seed(3)
    out, nodes, p_act, p_idle = schedules(gen, (1, 2, 2), 6, 3, [5, 5])
    tthermal.peak_temperature_grid(out, nodes, p_act, p_idle, bins=8,
                                   repeats=1)
    torch.cuda.synchronize()
    if sys.argv[1] == "pe":
        out["onpe"][0, 1, 1, 4, 2] = 5
    else:
        nodes[1, 3] = 3
    try:
        tthermal.peak_temperature_grid(out, nodes, p_act, p_idle, bins=8,
                                       repeats=1)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("refused:", e)
        sys.exit(0 if "CUDA error" in str(e) else 1)
    sys.exit(1)
""")


@pytest.mark.card
@pytest.mark.parametrize("bad", ["pe", "node"])
def test_kernel_refuses_indices_out_of_range(bad):
    """A PE index past P, or a node index past 2: the kernel traps (after
    a launch on good indices passes), which leaves the process's CUDA
    context unusable, so in a process of its own."""
    card()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", BAD_INDEX, bad], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.card
@pytest.mark.parametrize("lead,J,T,pes", [
    ((1, 3072), 1000, 8, [15]),
    ((1080, 4), 1000, 8, [1 + d % 19 for d in range(1080)]),
], ids=["static-3072x15", "dse-4320x19-padded"])
def test_kernel_at_the_benchmark_shapes(lead, J, T, pes):
    dev = card()
    gen = torch.Generator(dev).manual_seed(len(pes))
    out, *tables = schedules(gen, lead, J, T, pes, makespan_us=50_000.0)
    got = check(out, tables, 32, 3, against_cpu=False)
    # a lane alone: the same bits as inside the grid
    S, L = lead[-1], lead[0] * lead[-1]
    for lane in (0, 1, L // 2 + 1, L - 1):
        d, s = divmod(lane, S)
        one = {k: v[d:d + 1, s:s + 1] for k, v in out.items()}
        alone = tthermal.peak_temperature_grid(
            one, *[t[d:d + 1] for t in tables], bins=32, repeats=3)
        assert torch.equal(alone[0, 0], got[d, s]), lane


@pytest.mark.card
def test_run_and_sharded_sweep_lanes_equal_the_grid_bit_for_bit():
    """The thermal grid's lanes of a static sweep, alone through ``run``,
    and under ``sweep(shard=)`` over 4 virtual shards of the card: the same
    peak bits; one launch a scheduler and a block."""
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
    launches = metrics.counter("thermal_launches")
    before = launches.value
    whole = sweep(scn, axes, shard=False)
    assert launches.value == before + 2
    for i, j, k in ((0, 0, 0), (3, 1, 1), (5, 0, 1)):
        one = run(scn.replace(design=points[i],
                              scheduler=axes["scheduler"][j]).with_seed(
                                  axes["seed"][k]))
        assert np.float32(one.peak_temp_c) == whole.peak_temp_c[i, j, k]
    before = launches.value
    with virtual_lane_devices(4):
        sharded = sweep(scn, axes)
    assert launches.value == before + 2 * 4
    assert np.array_equal(sharded.peak_temp_c, whole.peak_temp_c)


@pytest.mark.card
def test_kernel_geometry_and_refusals():
    dev = card()
    info = tthermal.kernel_info(15, 32, dev)
    print("K6 at P=15, bins=32:", info)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 8
    gen = torch.Generator(dev).manual_seed(3)
    before = metrics.counter("thermal_launches").value
    out, *tables = schedules(gen, (1, 2), 8, 3, [33])
    with pytest.raises(ValueError, match="1..32 PEs"):
        tthermal.peak_temperature_grid(out, *tables)
    out, *tables = schedules(gen, (1, 2), 8, 3, [4])
    with pytest.raises(ValueError, match="shared memory"):
        tthermal.peak_temperature_grid(out, *tables, bins=40_000)
    with pytest.raises(ValueError, match="bins >= 1"):
        tthermal.peak_temperature_grid(out, *tables, bins=0)
    tables[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tthermal.peak_temperature_grid(out, *tables)
    assert metrics.counter("thermal_launches").value == before
