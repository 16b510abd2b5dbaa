"""K7, the epilogue kernel, on the CPU: the order of its sums and its
wrapper.

The kernel (``csrc/epilogue.cu``) sums each lane's cells, jobs and PEs in a
block of three warps a lane: thread t of a warp owns the values t (mod B),
takes its column's rows in bit-reversed order in groups of four, folds the
groups through a binary-counter stack and the B column totals by halving
(two cell warps split the rows by their lowest bit, the third sums the
jobs).  ``k7_tree`` models
that block algorithm in numpy, for any block width B and group size, and
must give ``kernels.epoch_scan.tree_sum``'s bits, which the plain version
(and so every CPU test of the port) sums by: random float32 of mixed
magnitude and sign, with zeros of both signs, from one value to 320,000
(the seconds cell's J·T), past and below each B.  ``k7_epilogue`` is the
kernel's whole epilogue on that model; it equals ``_epilogue`` on K1's
schedules (static, DTPM, fail-stop, stacked designs of padded PEs, one lane,
NaN in the cells that are not valid) bit for bit.  CPU tensors take the
plain version and launch nothing.  The kernel itself runs in
tests/test_torch_epilogue_card.py."""
import numpy as np
import pytest
import torch

from epilogue_cases import CASES, case, with_nan
from repro_torch.core import simkernel_torch as skt
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as k7
from repro_torch.kernels import epoch_scan as k1
from repro_torch.obs import metrics

torch.set_num_threads(1)


def _rev(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _pairs(leaves):
    """The adjacent-pair tree over a group's leaves (1, 2 or 4)."""
    while len(leaves) > 1:
        leaves = [leaves[i] + leaves[i + 1] for i in range(0, len(leaves), 2)]
    return leaves[0]


def k7_tree(x, B: int = 32, group: int = 4) -> np.ndarray:
    """Sum over the last axis as K7 does with a block of B threads: the n
    values zero-padded to W = 2^m; thread t owns column t of the R = W / B
    rows (one row of W columns when W < B) and takes the rows in
    bit-reversed order, ``group`` at a time (their pair tree in registers),
    each group's value merged into a binary-counter stack while the group
    index's low bits are ones; then the columns fold t += t + h for h = B/2
    .. 1.  float32 throughout."""
    x = np.asarray(x, np.float32)
    lead, n = x.shape[:-1], x.shape[-1]
    W = 1 << max(n - 1, 0).bit_length()
    width = min(B, W)
    R = W // width
    rho = R.bit_length() - 1
    gr = min(group, R)
    groups = R // gr
    levels = groups.bit_length() - 1
    rows = np.zeros(lead + (W,), np.float32)
    rows[..., :n] = x
    rows = rows.reshape(lead + (R, width))
    stack = [None] * levels
    for q in range(groups):
        carry = _pairs([rows[..., _rev(gr * q + i, rho), :] for i in range(gr)])
        j = 0
        while j < levels and (q >> j) & 1:
            carry = stack[j] + carry
            j += 1
        if j < levels:
            stack[j] = carry
    h = width // 2
    while h:
        carry = carry[..., :h] + carry[..., h:2 * h]
        h //= 2
    return carry[..., 0]


def mixed(rng, shape) -> np.ndarray:
    """float32 of magnitudes 1e-8 .. 1e8, either sign, with zeros of both
    signs: any other order of the sums changes bits."""
    x = (rng.choice([-1.0, 1.0], shape)
         * 10.0 ** rng.uniform(-8, 8, shape)).astype(np.float32)
    x.flat[::17] = 0.0
    x.flat[5::23] = -0.0
    return x


SIZES = [1, 2, 5, 31, 32, 33, 100, 1024, 8000, 320_000]


@pytest.mark.parametrize("B", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("n", SIZES)
def test_block_order_is_tree_sums(n, B):
    rng = np.random.default_rng(n * 7 + B)
    x = mixed(rng, (3, n))
    want = k1.tree_sum(torch.from_numpy(x)).numpy()
    got = k7_tree(x, B)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("n", [7, 8000, 33_333])
def test_block_order_holds_for_any_group(n, group):
    """The group size only moves the stack's lowest levels into registers."""
    x = mixed(np.random.default_rng(n + group), (2, n))
    want = k1.tree_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(k7_tree(x, 32, group).view(np.uint32),
                                  want.view(np.uint32))


def test_block_order_is_not_a_plain_sum():
    """The test's data tells orders apart: a left-to-right sum differs."""
    x = mixed(np.random.default_rng(1), (3, 8000))
    seq = np.zeros(3, np.float32)
    for i in range(x.shape[1]):
        seq = seq + x[:, i]
    assert not np.array_equal(seq.view(np.uint32),
                              k7_tree(x).view(np.uint32))


def k7_epilogue(tables, arrival, app_idx, schedule):
    """The kernel's outputs by its own arithmetic on numpy: a job's finish
    the latest of its valid tasks', busy time finish - start on a valid cell
    and a selected 0 elsewhere (PE -1: no slot), the active energy busy *
    the PE's power (at the latched OPP under DTPM), each sum ``k7_tree``;
    the idle energy over the PEs, then (active + idle) * 1e-6."""
    _, start, finish, onpe, *opp = [x.numpy() for x in schedule]
    arrival, app_idx = arrival.numpy(), app_idx.numpy()
    L, J, T = start.shape
    design = k1.lane_designs(tables, L).numpy()
    valid = k1.per_design(tables, "valid").numpy()[design[:, None], app_idx]
    fin = np.where(valid, finish, np.float32(0))
    job_finish = fin.max(axis=2)
    makespan = job_finish.max(axis=1)
    busy = np.where(valid, finish - start, np.float32(0)).reshape(L, -1)
    pe = np.where(valid, onpe, -1).reshape(L, -1)
    if opp:
        K = tables.power_active_opp.shape[-1]
        power = k1.per_design(tables, "power_active_opp").numpy()[design] \
            .reshape(L, -1)
        index = np.maximum(pe, 0) * K + opp[0].reshape(L, -1)
    else:
        power = k1.per_design(tables, "power_active").numpy()[design]
        index = np.maximum(pe, 0)
    active = np.where(pe >= 0, busy * np.take_along_axis(power, index, 1),
                      np.float32(0))
    P = tables.num_pes
    per_pe = np.stack([k7_tree(np.where(pe == k, busy, np.float32(0)))
                       for k in range(P)], axis=1)
    idle = k1.per_design(tables, "power_idle").numpy()[design] * np.maximum(
        makespan[:, None] - per_pe, np.float32(0))
    return {"job_finish": job_finish, "makespan_us": makespan,
            "avg_job_latency_us": k7_tree(job_finish - arrival)
            / np.float32(J),
            "busy_per_pe_us": per_pe,
            "energy_j": (k7_tree(active) + k7_tree(idle)) * np.float32(1e-6)}


@pytest.mark.parametrize("nan", [False, True], ids=["as_scanned", "nan"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_arithmetic_equals_the_plain_epilogue(name, nan):
    tables, arrival, app_idx, schedule = case(name, "cpu")
    if nan:
        schedule = with_nan(tables, app_idx, schedule)
    got = skt._epilogue(tables, arrival, app_idx, *schedule)
    want = k7_epilogue(tables, arrival, app_idx, schedule)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, key
        assert np.isfinite(g).all(), key
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=key)
    for i, key in enumerate(("scheduled", "start", "finish", "onpe")):
        assert got[key] is schedule[i]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    tables, arrival, app_idx, schedule = case("dtpm", "cpu")
    calls = []
    plain = k7.epilogue_plain
    monkeypatch.setattr(k7, "epilogue_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = metrics.counter(k7.LAUNCHES).value
    got = skt._epilogue(tables, arrival, app_idx, *schedule)
    assert calls == [1]
    assert metrics.counter(k7.LAUNCHES).value == before
    want = plain(tables, arrival, app_idx, *schedule)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_kernel_source_is_built_and_unknown_devices_raise():
    assert "epilogue.cu" in {p.name for p in _build.sources()}
    tables, arrival, app_idx, schedule = case("one_lane", "cpu")
    meta = [x.to("meta") for x in (arrival, app_idx, *schedule)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k7.epilogue(tables, *meta)


def test_run_manifest_reports_epilogue_launches():
    man = metrics.run_manifest()
    assert man["epilogue_launches"] == metrics.counter(k7.LAUNCHES).value
    assert isinstance(man["epilogue_launches"], int)
