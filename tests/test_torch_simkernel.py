"""The port's epoch scan (K1's plain version and the shared epilogue) against
the JAX package's ``simulate_jax`` / ``simulate_batch`` on the cases of
tests/test_sim_equivalence.py, fed identical tables through
``tables_from_numpy``.

Tolerances: ``scheduled``, ``start``, ``finish``, ``onpe``, ``job_finish`` and
``makespan_us`` are bit-for-bit (maxima, one f32 op per rounding, the same
order); ``avg_job_latency_us``, ``energy_j`` and ``busy_per_pe_us`` are sums
that XLA and torch take in different orders, held to 1e-6 relative.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import (build_tables, deterministic_trace, get_application,
                        make_soc_table2, poisson_trace, solve_optimal_table,
                        wifi_tx)
from repro.core.applications import Application, Task
from repro.core.dvfs import OndemandGovernor
from repro.core.resources import ALL_PROFILES, CommModel
from repro.core.simkernel_jax import simulate_batch, simulate_jax
from repro_torch.core import simkernel_ref as tref
from repro_torch.core import simkernel_torch as skt
from repro_torch.core.applications import wifi_tx as t_wifi_tx
from repro_torch.core.jobgen import deterministic_trace as t_det_trace
from repro_torch.core.resources import CommModel as TCommModel
from repro_torch.core.resources import make_soc_table2 as t_soc
from repro_torch.core.schedulers import get_scheduler as t_get_scheduler
from repro_torch.kernels import epoch_scan as k1
from repro_torch.kernels import ops

torch.set_num_threads(1)

APPS5 = ["wifi_tx", "wifi_rx", "single_carrier", "range_detection",
         "pulse_doppler"]
EXACT = ("scheduled", "start", "finish", "onpe", "job_finish", "makespan_us")
SUMS = ("avg_job_latency_us", "energy_j", "busy_per_pe_us")


def port_tables(tb):
    """The JAX package's tables, carried across as numpy."""
    return skt.tables_from_numpy(jax.tree_util.tree_map(np.asarray, tb),
                                 tb.t_max, tb.num_pes, "cpu")


def assert_outputs_match(got, want):
    assert set(got) == set(want)
    for key in EXACT:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    for key in SUMS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


def run_both(db, apps, trace, policy, table=None):
    tb = build_tables(db, apps, table=table)
    want = simulate_jax(tb, policy, trace.arrival_us, trace.app_index)
    got = skt.simulate_torch(port_tables(tb), policy, trace.arrival_us,
                             trace.app_index)
    assert_outputs_match(got, want)
    return got


@pytest.mark.parametrize("policy", ["met", "etf", "table"])
@pytest.mark.parametrize("rate", [2.0, 20.0, 60.0])
def test_scan_equals_simulate_jax_wifi_tx(policy, rate):
    db = make_soc_table2()
    app = wifi_tx()
    table = solve_optimal_table(db, app) if policy == "table" else None
    run_both(db, [app], poisson_trace(rate, 80, ["wifi_tx"], seed=int(rate)),
             policy, table)


@pytest.mark.parametrize("policy", ["met", "etf", "table"])
def test_scan_equals_simulate_jax_five_app_mix(policy):
    db = make_soc_table2(with_viterbi=True)
    apps = [get_application(n) for n in APPS5]
    table = None
    if policy == "table":
        table = {}
        for app in apps:
            table.update(solve_optimal_table(db, app))
    run_both(db, apps, poisson_trace(15.0, 60, APPS5, seed=7), policy, table)


def test_exact_schedule_equality_comm_free():
    """Integer latencies + zero comm: the scan equals simulate_jax and the
    port's own event-heap oracle bit for bit."""
    db = make_soc_table2()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    got = run_both(db, [wifi_tx()], trace, "etf")
    tdb = t_soc()
    tdb.comm = TCommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    ref = tref.simulate(tdb, [t_wifi_tx()], t_det_trace(25.0, 64, ["wifi_tx"]),
                        t_get_scheduler("etf"))
    fin, onpe = got["finish"].numpy(), got["onpe"].numpy()
    for r in ref.records:
        assert fin[r.job_id, r.task_id] == np.float32(r.finish_us)
        assert onpe[r.job_id, r.task_id] == r.pe_id


@pytest.mark.parametrize("policy", ["etf", "met"])
def test_batch_equals_simulate_batch_and_the_single_runs(policy):
    db = make_soc_table2()
    tb = build_tables(db, [wifi_tx()])
    traces = [poisson_trace(r, 40, ["wifi_tx"], seed=s)
              for r in (5.0, 30.0) for s in (0, 1)]
    arr = np.stack([t.arrival_us for t in traces])
    idx = np.stack([t.app_index for t in traces])
    want = simulate_batch(tb, policy, arr, idx)
    tt = port_tables(tb)
    got = skt.simulate_batch(tt, policy, arr, idx)
    assert_outputs_match(got, want)
    for k, t in enumerate(traces):
        single = skt.simulate_torch(tt, policy, t.arrival_us, t.app_index)
        for key in got:
            np.testing.assert_array_equal(single[key].numpy(),
                                          got[key][k].numpy(), err_msg=key)


def _random_app(rng):
    """A random DAG of 1-8 profiled tasks (the property test's generator,
    drawn from a numpy seed)."""
    names = sorted(ALL_PROFILES)
    n = int(rng.integers(1, 9))
    tasks = []
    for i in range(n):
        k = int(rng.integers(0, min(i, 3) + 1)) if i else 0
        preds = tuple(sorted(rng.choice(i, size=k, replace=False).tolist())) \
            if k else ()
        tasks.append(Task(names[int(rng.integers(len(names)))], i, preds,
                          float(rng.choice([256, 1024, 4096]))))
    return Application("rand", tuple(tasks))


@pytest.mark.parametrize("seed", range(6))
def test_scan_equals_simulate_jax_on_random_dags(seed):
    rng = np.random.default_rng(seed)
    app = _random_app(rng)
    rate = float(rng.choice([2.0, 20.0, 80.0]))
    policy = ["met", "etf"][seed % 2]
    db = make_soc_table2(with_viterbi=True)
    run_both(db, [app], poisson_trace(rate, 20, ["rand"], seed=seed), policy)


def test_scan_on_padded_tables():
    """Padded task rows and PE columns are inert, as in the reference."""
    db = make_soc_table2(with_viterbi=True)
    apps = [get_application(n) for n in APPS5[:3]]
    trace = poisson_trace(30.0, 30, APPS5[:3], seed=4)
    tb = build_tables(db, apps, pad_tasks=11, pad_pes=19)
    want = simulate_jax(tb, "etf", trace.arrival_us, trace.app_index)
    got = skt.simulate_torch(port_tables(tb), "etf", trace.arrival_us,
                             trace.app_index)
    assert_outputs_match(got, want)


def test_the_static_scan_refuses_dynamic_tables_faults_and_bad_tables():
    db = make_soc_table2()
    trace = poisson_trace(10.0, 6, ["wifi_tx"], seed=0)
    dyn = port_tables(build_tables(db, [wifi_tx()], governor=OndemandGovernor()))
    with pytest.raises(ValueError, match="dynamic governor"):
        skt.simulate_torch(dyn, "etf", trace.arrival_us, trace.app_index)
    tt = port_tables(build_tables(db, [wifi_tx()]))
    # faults run under met and etf; the table policy cannot route around a
    # dead PE, and a plan must have one fail time a PE
    with pytest.raises(ValueError, match="PE-masking"):
        skt.simulate_torch(tt, "table", trace.arrival_us, trace.app_index,
                           faults=np.full(db.num_pes, np.inf, np.float32))
    with pytest.raises(ValueError, match="faults"):
        skt.simulate_torch(tt, "etf", trace.arrival_us, trace.app_index,
                           faults=np.full(db.num_pes + 1, np.inf, np.float32))
    with pytest.raises(ValueError, match="unknown policy"):
        skt.simulate_torch(tt, "heft", trace.arrival_us, trace.app_index)
    # tables built without an offline table: every valid task_pe is -1
    with pytest.raises(ValueError, match="table_pe == -1"):
        skt.simulate_torch(tt, "table", trace.arrival_us, trace.app_index)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    db = make_soc_table2()
    tt = port_tables(build_tables(db, [wifi_tx()]))
    trace = poisson_trace(10.0, 12, ["wifi_tx"], seed=2)
    arr = torch.from_numpy(trace.arrival_us)[None]
    idx = torch.from_numpy(trace.app_index)[None]
    before = k1.launches
    got = ops.epoch_scan(tt, "etf", arr, idx)
    want = k1.epoch_scan_plain(tt, "etf", arr, idx)
    assert k1.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[0].all())


def test_predecessor_bit_masks():
    pred = torch.zeros((2, 32, 32), dtype=torch.bool)
    pred[0, 5, [0, 3, 31]] = True
    pred[1, 0, 31] = True
    bits = k1._bits(pred)
    assert bits.dtype == torch.int32
    assert int(bits[0, 5]) & 0xffffffff == (1 | 8 | (1 << 31))
    assert int(bits[1, 0]) & 0xffffffff == 1 << 31
    assert int(bits[0, 0]) == 0
    # a block is a lane: its design's tables (two words an app: its valid
    # tasks and first roots), then its slice (group minima and job keys
    # (int64), queues, done masks) over the ring's 1,024 slots, each rounded
    # up to 8 bytes
    tables, lane = 600 + 320 + 225 + 80 + 10 + 1, 2 * 32 + 2 * 1024 + 15 + 1024 + 1
    assert k1.shared_bytes(1000, 5, 8, 15) == 4 * (tables + lane)
    # 37 jobs: a ring of 64 slots, two groups of 32; 34 table words
    assert k1.shared_bytes(37, 1, 2, 4) == 4 * (34 + 2 * 2 + 2 * 64 + 4 + 64)


def test_kernel_preparation_checks_the_tables_once():
    db = make_soc_table2()
    tt = port_tables(build_tables(db, [wifi_tx()]))
    hit = k1._prepare(tt, "etf")
    assert k1._prepare(tt, "met") is hit
    np.testing.assert_array_equal(hit["pred_bits"].numpy(),
                                  k1._bits(tt.pred).numpy())
    with pytest.raises(ValueError, match="table_pe == -1"):
        k1._prepare(tt, "table")
    bad = dataclasses.replace(tt, pred=tt.pred[:, :3])
    with pytest.raises(ValueError, match="tables.pred"):
        k1._prepare(bad, "etf")
