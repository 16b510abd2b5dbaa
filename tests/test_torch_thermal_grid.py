"""The thermal grid's wrapper on the CPU: CPU tensors take
``peak_temperature_grid_plain`` and equal ``repro.dse.thermal_jax`` at 1e-5
(peak temperature; the busy sums round in another order), over bin counts
past one warp's 32 and up to the kernel's 32 PEs, an all-unscheduled lane,
a zero makespan, bins that PEs fill in part and a period that heats and
cools; a PE or node index out of range raises; the kernel's source is
built, an unknown device raises, and the run manifest reports the kernel's
launches.  The kernel itself runs in tests/test_torch_thermal_card.py."""
import numpy as np
import pytest
import torch

from repro.dse import thermal_jax as jthermal
from repro_torch.dse import thermal_torch as tthermal
from repro_torch.kernels import _build
from repro_torch.obs import metrics
from thermal_schedules import (BIN_CASES, BIN_PES, assert_bins_matter,
                               schedules)

torch.set_num_threads(1)


def numpy_case(seed, lead, J, T, pes, **kw):
    """A random case (tests/thermal_schedules.py) as numpy arrays, the form
    both packages take."""
    out, *tables = schedules(torch.Generator().manual_seed(seed), lead, J, T,
                             pes, **kw)
    return ({k: v.numpy() for k, v in out.items()},
            *[t.numpy() for t in tables])


def jax_grid(out, nodes, p_act, p_idle, bins, repeats):
    """The reference over a leading fault axis (it vmaps (D, S) only)."""
    F = out["makespan_us"].shape[0]
    return np.stack([np.asarray(jthermal.peak_temperature_grid(
        {k: v[f] for k, v in out.items()}, nodes, p_act, p_idle, bins=bins,
        repeats=repeats)) for f in range(F)])


def torch_grid(out, nodes, p_act, p_idle, bins, repeats):
    t = torch.from_numpy
    return tthermal.peak_temperature_grid(
        {k: t(v) for k, v in out.items()}, t(nodes), t(p_act), t(p_idle),
        bins=bins, repeats=repeats)


@pytest.mark.parametrize("bins,P", [(1, 7), (40, 15), (32, 32), (40, 32)])
def test_cpu_grid_equals_thermal_jax(bins, P, monkeypatch):
    """Past one warp's bins and at the kernel's widest P, with a leading
    fault axis; CPU tensors go to the plain version, which launches
    nothing."""
    F, D, S = 2, 3, 2
    out, nodes, p_act, p_idle = numpy_case(bins * 100 + P, (F, D, S), 12, 5,
                                           [P] * D)
    want = jax_grid(out, nodes, p_act, p_idle, bins, 2)
    calls = []
    plain = tthermal.peak_temperature_grid_plain
    monkeypatch.setattr(tthermal, "peak_temperature_grid_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = metrics.counter("thermal_launches").value
    got = torch_grid(out, nodes, p_act, p_idle, bins, 2)
    assert calls == [1]
    assert metrics.counter("thermal_launches").value == before
    assert got.shape == (F, D, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_cpu_grid_all_unscheduled_lane_and_zero_makespan():
    """A lane with nothing scheduled draws idle power only, and its zero
    makespan takes the 1e-6 us clamp, as in the reference."""
    out, nodes, p_act, p_idle = numpy_case(5, (1, 2, 3), 10, 4, [9, 9])
    out["scheduled"][0, 1, 2] = False
    out["makespan_us"][0, 1, 2] = 0.0
    out["makespan_us"][0, 0, 0] = 0.0          # busy cells, zero makespan
    want = jax_grid(out, nodes, p_act, p_idle, 12, 3)
    got = torch_grid(out, nodes, p_act, p_idle, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    idle = tthermal.steady_state(torch.stack([
        torch.from_numpy(p_idle[1])[torch.from_numpy(nodes[1]) == n].sum()
        for n in range(3)]))
    np.testing.assert_allclose(float(got[0, 1, 2]),
                               float(idle[:3].max()), rtol=1e-5)


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_cpu_grid_equals_thermal_jax_where_bins_matter(case):
    kw = BIN_CASES[case][0]
    out, nodes, p_act, p_idle = numpy_case(11, (2, len(BIN_PES), 2),
                                           pes=BIN_PES, **kw)
    want = jax_grid(out, nodes, p_act, p_idle, 32, 3)
    got = torch_grid(out, nodes, p_act, p_idle, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    t = torch.from_numpy
    assert_bins_matter({k: t(v) for k, v in out.items()},
                       (t(nodes), t(p_act), t(p_idle)), 32, got, case, 1e-5)


@pytest.mark.parametrize("bad", ["pe", "node"])
def test_plain_grid_refuses_indices_out_of_range(bad):
    """A PE index past P on a cell, or a node index past 2: the one-hots
    raise (the kernel traps on the same inputs)."""
    out, nodes, p_act, p_idle = numpy_case(3, (1, 2, 2), 6, 3, [5, 5])
    if bad == "pe":
        out["onpe"][0, 1, 1, 4, 2] = 5
    else:
        nodes[1, 3] = 3
    with pytest.raises(RuntimeError, match="num_classes"):
        torch_grid(out, nodes, p_act, p_idle, 8, 1)


def test_kernel_source_is_built_and_unknown_devices_raise():
    assert "thermal_grid.cu" in {p.name for p in _build.sources()}
    out = {k: torch.zeros((1, 1, 2, 3), device="meta")
           for k in ("start", "finish")}
    out["onpe"] = torch.zeros((1, 1, 2, 3), dtype=torch.int32, device="meta")
    out["scheduled"] = torch.zeros((1, 1, 2, 3), dtype=torch.bool,
                                   device="meta")
    out["makespan_us"] = torch.zeros((1, 1), device="meta")
    tables = (torch.zeros((1, 4), dtype=torch.int32, device="meta"),
              torch.zeros((1, 4), device="meta"),
              torch.zeros((1, 4), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tthermal.peak_temperature_grid(out, *tables)


def test_kernel_geometry_and_constants_on_the_host():
    """The RC constants the wrapper packs for the kernel (whose C entry
    checks their count, and the grid's geometry): the float32 roundings of
    the values that ``exact_step_matrices`` and ``peak_temperature``
    use."""
    c = tthermal.rc_constants()
    assert c.dtype == np.float32 and c.shape == (77,)
    lam, proj = tthermal._ref._rc_spectral()
    np.testing.assert_array_equal(c[:4], np.float32(lam))
    np.testing.assert_array_equal(c[4:68].reshape(4, 4, 4),
                                  np.float32(proj))
    np.testing.assert_array_equal(c[68:71], np.float32(tthermal._ref.R_TO_BOARD))
    np.testing.assert_array_equal(c[71:74], np.float32(tthermal._ref.C_NODE))
    assert c[74:].tolist() == [np.float32(v) for v in (
        tthermal._ref.T_AMBIENT_C, tthermal._ref.R_BOARD_AMB,
        tthermal._ref.C_BOARD)]


def test_run_manifest_reports_thermal_launches():
    man = metrics.run_manifest()
    assert man["thermal_launches"] == metrics.counter("thermal_launches").value
    assert isinstance(man["thermal_launches"], int)
