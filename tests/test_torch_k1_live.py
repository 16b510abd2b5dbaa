"""K1's live window on the CPU: its shared-memory geometry and the registry
counters ``k1_live_jobs_peak`` / ``k1_overflow_lanes``.

The fault-free programs hold only the live jobs, in a ring of
``job_slots(J)`` slots (at most 1,024), so a block's shared bytes stop
growing with J; the fail-stop ones keep every job.  The counters follow the
program spans (tests/test_torch_spans.py): off (no ``torch.profiler``
session) K1's wrapper hands nothing over and the registry is left as it
was; live, each card launch hands over the kernel's per-lane count, which
the manifest reads (after a synchronise) into the counters and shows beside
``k1_launches``.  A CPU call runs the plain scan, which holds no window,
and hands nothing over.  The card's own counts are held against
``kernel_live`` (tests/k1_window.py) in
tests/test_torch_epoch_scan_long_card.py.
"""
import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.jobgen import poisson_trace
from repro_torch.dse import DesignPoint
from repro_torch.kernels import epoch_scan as k1
from repro_torch.kernels import ops
from repro_torch.obs import metrics
from repro_torch.scenario import Scenario, TraceSpec, tables_for

sweep = importlib.import_module("repro_torch.scenario.sweep").sweep

APPS = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
        "pulse_doppler")
POLICIES = [(("sample_window_us", 50.0), ("up_threshold", 0.6)),
            (("sample_window_us", 100.0), ("up_threshold", 0.9))]
BASE = Scenario(governor="ondemand",
                trace=TraceSpec(rate_jobs_per_ms=40.0, num_jobs=100, seed=5))


def test_the_ring_sets_the_shared_bytes_not_the_jobs():
    assert [k1.job_slots(J) for J in (1, 32, 33, 100, 1000, 1024, 1025,
                                      40_000)] == \
        [32, 32, 64, 128, 1024, 1024, 1024, 1024]
    assert k1.job_slots(40_000, faults=True) == 40_000
    assert k1.spill_words(40_000) == 40_000 + 1250 + 20_000
    for CK in ((0, 0), (3, 5)):
        at = [k1.shared_bytes(J, 5, 8, 15, *CK) for J in (1000, 1024, 40_000,
                                                          10 ** 6)]
        assert len(set(at)) == 1, at
        # below the ring's top the slots shrink with J
        assert k1.shared_bytes(100, 5, 8, 15, *CK) < at[0]
        # the fail-stop programs keep 12 bytes and a floor mask a job
        faults = [k1.shared_bytes(J, 5, 8, 15, *CK, True) for J in (1000, 2000)]
        assert faults[1] - faults[0] == 4 * (3 * 1000 + 2 * 1000 // 32 + 1000)
        assert k1.shared_bytes(13_000, 5, 8, 15, *CK, True) <= k1.MAX_SHARED
    # the Table-2 SoC: 12 static and 8 DTPM lanes an SM of 228 KB (1 KB a
    # block reserved, 128-byte granules), as with every job in shared memory
    for CK, lanes in (((0, 0), 12), ((3, 5), 8)):
        block = -(-k1.shared_bytes(40_000, 5, 8, 15, *CK) // 128) * 128 + 1024
        assert 228 * 1024 // block == lanes


def dtpm_sweep():
    return sweep(BASE, {"design": [DesignPoint(), DesignPoint(num_fft=2)],
                        "governor_params": POLICIES, "seed": [0, 1]},
                 device="cpu")


def _counters():
    return (metrics.counter(metrics.K1_LIVE_PEAK).value,
            metrics.counter(metrics.K1_OVERFLOW).value)


def test_off_the_wrapper_hands_nothing_over(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("k1_live called with no profiler recording")
    monkeypatch.setattr(metrics, "k1_live", refuse)
    before = _counters()
    dtpm_sweep()
    assert _counters() == before


def test_live_the_manifest_reads_what_launches_handed_over():
    """Two launches' counts (as K1's wrapper hands them over while a
    profiler records): the most jobs any lane held, and the lanes above
    their ring's slots, read once, in the manifest."""
    metrics.run_manifest(device="cpu")              # nothing left pending
    metrics.counter(metrics.K1_LIVE_PEAK).reset()
    before = metrics.counter(metrics.K1_OVERFLOW).value
    metrics.k1_live(torch.tensor([40, 1000, 7], dtype=torch.int32), 1024)
    metrics.k1_live(torch.tensor([33, 1900, 1025, 1024], dtype=torch.int32),
                    1024)
    assert _counters() == (0, before)               # not read before the manifest
    man = metrics.run_manifest(device="cpu")
    assert (man[metrics.K1_LIVE_PEAK], man[metrics.K1_OVERFLOW]) == (
        1900, before + 2)
    assert list(man).index(metrics.K1_LIVE_PEAK) == list(man).index(
        "k1_launches") + 1
    # read once: a second manifest adds nothing
    again = metrics.run_manifest(device="cpu")
    assert again[metrics.K1_OVERFLOW] == before + 2


def test_live_a_cpu_call_hands_nothing_over(monkeypatch):
    """The plain scan on the CPU holds no window: while a profiler records,
    a sweep and an overloaded lane (two PEs at 80 jobs/ms, a backlog past
    the ring on a card) hand nothing over, and the manifest's counters stay
    where they were."""
    handed = []
    monkeypatch.setattr(metrics, "k1_live", lambda *a: handed.append(a))
    scn = Scenario(design=DesignPoint(num_big=1, num_little=1, num_scr=0,
                                      num_fft=0), apps=APPS)
    tables = tables_for(scn, device="cpu")
    tr = poisson_trace(80.0, 1100, APPS, seed=1)
    arr = torch.from_numpy(tr.arrival_us)[None]
    app = torch.from_numpy(tr.app_index)[None]
    before = metrics.run_manifest(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        got = dtpm_sweep()
        ops.epoch_scan(tables, "etf", arr, app)
    after = metrics.run_manifest(device="cpu")
    assert handed == []
    assert (after[metrics.K1_LIVE_PEAK], after[metrics.K1_OVERFLOW]) == (
        before[metrics.K1_LIVE_PEAK], before[metrics.K1_OVERFLOW])
    assert np.isfinite(got.avg_latency_us).all()
