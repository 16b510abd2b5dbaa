"""CPU tests of the benchmark's harness (``ds3bench/``).

    PYTHONPATH=src python -m pytest -q ds3bench/tests

They run the harness on the CPU (the port's ``device="cpu"`` path) at tiny
sizes; the test marked ``card`` runs a real cell on a CUDA card and skips
without one.
"""
from __future__ import annotations

import ast
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import ds3bench_tiny  # noqa: E402
from ds3bench.harness import check, inputs, profile, runner, spec  # noqa: E402
from ds3bench.harness.k1bytes import Launch  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return ds3bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=SEED, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run_cell(root, cell, seed, 0.0, trace, device="cpu",
                         out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


# ------------------------------------------------------------ found by name

def test_benchmark_names_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("cell", ["static-rate-sweep", "dtpm-policy-sweep",
                                  "dse-grid-evaluate"])
def test_cell_found_by_name(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.config["apps"] and c.traffic["entry"] in ("sweep", "evaluate")
    assert set(c.limits) <= set(check.NUMBERS)
    names = {m.name for m in c.metrics}
    assert {"sim_tasks_per_s", "setup_s", "launches_per_call",
            "k1_ms_per_call", "k1_roofline", "device_idle_pct",
            "other_kernels_ms_per_call"} <= names
    assert ("call_p95_ms" in names) == (cell != "dse-grid-evaluate")
    assert ("tables_ms_per_call" in names) == (cell == "dse-grid-evaluate")


# ------------------------------------------------------------ inputs

def test_seed_gives_the_same_traces():
    tr = json.loads((ROOT / "ds3bench/traffic/rate-sweep.json").read_text())
    spec_ = dict(tr["traces"], jobs=50)
    a = inputs.pool(spec_, 5, SEED, 2)
    b = inputs.pool(spec_, 5, SEED, 2)
    c = inputs.pool(spec_, 5, SEED + 1, 2)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(x.arrival_us, y.arrival_us)
        assert np.array_equal(x.app_index, y.app_index)
    # another seed: the same rates and sizes, other draws; the sets of a
    # pool differ from each other
    assert [t.rate_jobs_per_ms for t in a[0]] == \
        [t.rate_jobs_per_ms for t in c[0]]
    assert [t.arrival_us.shape for t in a[0]] == \
        [t.arrival_us.shape for t in c[0]]
    assert not np.array_equal(a[0][0].arrival_us, c[0][0].arrival_us)
    assert not np.array_equal(a[0][0].arrival_us, a[1][0].arrival_us)
    assert len(a[0]) == 32 * 32
    assert all(t.arrival_us.dtype == np.float32 and
               np.all(np.diff(t.arrival_us) >= 0) for t in a[0])


# ------------------------------------------------------------ metrics

def _reader(name):
    return spec._reader(ROOT, name)


def _calls(seconds, tasks):
    t, out = 100.0, []
    for s, n in zip(seconds, tasks):
        out.append(runner.CallRecord(t, t + s, n, 1, []))
        t += s
    return out


def test_sim_tasks_per_s_is_all_work_over_the_whole_window():
    calls = _calls([0.2, 0.3, 0.25, 0.9], [10, 20, 30, 40])
    window = calls[-1].end - calls[0].start + 0.05
    run = runner.RunRecord("c", 1.0, window, calls)
    assert _reader("sim_tasks_per_s")(run) == pytest.approx(100 / window)
    assert _reader("setup_s")(run) == 1.0


def test_call_p95_ms_is_taken_over_all_calls():
    secs = list(np.linspace(0.1, 0.2, 19)) + [1.5]       # one slow call
    run = runner.RunRecord("c", 1.0, 10.0, _calls(secs, [1] * 20))
    got = _reader("call_p95_ms")(run)
    assert got == pytest.approx(1e3 * np.percentile(secs, 95))
    # not the median of chunk medians, nor the p95 of chunk medians
    chunks = [np.median(secs[i:i + 5]) for i in range(0, 20, 5)]
    assert got > 1e3 * max(chunks) * 1.3


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction_and_per_layer_readers():
    ev = [_event("user_annotation", "ds3bench.call", 0, 1000),
          _event("user_annotation", "ds3bench.tables", 10, 400),
          _event("cpu_op", "aten::cat", 20, 100),
          _event("kernel", "void epoch_scan_kernel<false, false>(...)",
                 450, 200),
          _event("kernel", "elementwise", 700, 100),
          _event("gpu_memcpy", "Memcpy DtoH", 800, 50),
          _event("user_annotation", "ds3bench.call", 1000, 1000),
          _event("kernel", "void epoch_scan_kernel<false, false>(...)",
                 1100, 300),
          _event("kernel", "elementwise", 1300, 200)]  # overlaps K1
    s = profile.summarize(ev)
    assert s.calls == 2 and s.window_s == pytest.approx(2000e-6)
    assert s.busy_s == pytest.approx((200 + 150 + 400) * 1e-6)
    assert sum(g for _, g in s.idle_gaps) == pytest.approx(
        s.window_s - s.busy_s)
    labels = dict(s.gaps_by_label())
    # 0..450 us: its middle inside the tables span; the rest inside calls
    assert labels == pytest.approx({"ds3bench.tables": 450e-6,
                                    "ds3bench.call": 800e-6})
    l1 = Launch(False, 1, 1024, 1000, 5, 8, 15)
    run = runner.RunRecord("c", 1.0, s.window_s,
                           [runner.CallRecord(0, 1, 0, 0, [l1]),
                            runner.CallRecord(1, 2, 0, 0, [l1])], s)
    assert _reader("launches_per_call")(run) == 2.0
    assert _reader("k1_ms_per_call")(run) == pytest.approx(0.25)
    assert _reader("k1_roofline")(run) == pytest.approx(
        100 * 2 * l1.bound_s / 500e-6)
    assert _reader("other_kernels_ms_per_call")(run) == pytest.approx(0.175)
    assert _reader("tables_ms_per_call")(run) == pytest.approx(0.2)
    assert _reader("device_idle_pct")(run) == pytest.approx(
        100 * (1 - 750 / 2000))
    # nothing to read: no metric, never a 0
    empty = runner.RunRecord("c", 1.0, 1.0, [], profile.summarize([]))
    for name in ("launches_per_call", "k1_ms_per_call", "k1_roofline",
                 "other_kernels_ms_per_call", "tables_ms_per_call",
                 "device_idle_pct", "sim_tasks_per_s", "call_p95_ms"):
        assert _reader(name)(empty) is None


def test_k1_bytes_match_the_kernel_table():
    """The frozen byte count gives the bounds of PERF.md's K1 rows."""
    assert 1e3 * Launch(False, 1, 1024, 1000, 5, 8, 15).bound_s == \
        pytest.approx(0.03424, abs=5e-6)
    assert 1e3 * Launch(True, 64, 1024, 1000, 5, 8, 18).bound_s == \
        pytest.approx(0.04441, abs=5e-6)
    assert 1e3 * Launch(False, 1080, 4320, 1000, 5, 8, 19).bound_s == \
        pytest.approx(0.14640, abs=5e-6)
    # the fail-stop rows: 16 fault sets x 1,024 traces, static and DTPM
    assert 1e3 * Launch(False, 1, 16384, 1000, 5, 8, 15,
                        faults=True).bound_s == pytest.approx(0.70460,
                                                              abs=5e-6)
    assert 1e3 * Launch(True, 1, 16384, 1000, 5, 8, 15,
                        faults=True).bound_s == pytest.approx(0.86191,
                                                              abs=5e-6)
    # the five cells' launches, fault-free: the bytes they had before the
    # count took faults
    was = {"static-rate-sweep": [114_692_928] * 3,
           "dtpm-policy-sweep": [148_780_288],
           "dse-grid-evaluate": [490_440_960],
           "dtpm-seconds-sweep": [5_898_423_100],
           "dtpm-policy-sweep-met": [148_780_288]}
    for cell, want in was.items():
        c = spec.load_cell(ROOT, cell)
        tr = c.traffic["traces"]
        jobs = int(tr["jobs"])
        trace = inputs.Trace(np.zeros(jobs, np.float32),
                             np.zeros(jobs, np.int32), 20.0)
        n = len(inputs.rates(tr["rates_jobs_per_ms"])) * int(tr["per_rate"])
        got = runner.entries.make(c.config, c.traffic, "cpu").launches(
            [trace] * n)
        assert [l.bytes for l in got] == want, cell
        assert not any(l.faults for l in got)


# ------------------------------------------------------------ whole runs

@pytest.mark.parametrize("cell", ds3bench_tiny.CELLS)
def test_a_cell_added_as_data_alone_runs_and_is_correct(tiny_root, cell):
    """The tiny cells are data files alone (configuration, traffic,
    limits, BENCHMARK.json entries); each runs on the port's CPU path,
    traced and untraced, and its answers match the reference within the
    real cell's limits."""
    for trace in (False, True):
        rc, res, err = _run(tiny_root, cell, trace=trace)
        assert rc == 0 and res["correct"], err
        assert res["failed"] == 0 and res["attempted"] > 0
        assert list(res)[-1] == "checks"
        assert set(res["checks"]) == set(
            spec.load_cell(tiny_root, cell).limits)
        assert err.strip().splitlines()[-1].startswith("check ")
        if not trace:
            assert res["metrics"]["sim_tasks_per_s"]["value"] > 0
            assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", ds3bench_tiny.CELLS)
def test_the_reference_equals_the_port_on_the_cpu(tiny_root, cell):
    """Every lane of a tiny call of each entry (static sweep, DTPM sweep,
    evaluate) on the port's CPU path against the reference: the same
    makespan to the bit, the sums to float32 rounding."""
    prep = runner.prepare(tiny_root, cell, SEED, "cpu")
    _, outs, _ = runner.timed_calls(prep, 0.0, "cpu")
    i, out = outs[0]
    worst = check.widest([
        check.gaps(runner.entries.lane_answers(out, prep.shape, n),
                   check.reference(prep.cell.config, lane,
                                   prep.sets[i][lane.trace]))
        for n, lane in enumerate(prep.lanes[i])])
    assert worst.get("makespan", 0.0) == 0.0
    for k in ("latency", "energy", "busy"):
        assert worst.get(k, 0.0) < 1e-6, (k, worst)
    assert worst["temp"] < 1e-2


def _patched(monkeypatch, target, name, wrap):
    orig = getattr(target, name)
    monkeypatch.setattr(target, name, wrap(orig))


def _half_mean(orig):
    """Average latency over the first half of the jobs only."""
    def f(tables, arrival, app_idx, *a, **kw):
        out = orig(tables, arrival, app_idx, *a, **kw)
        J = out["job_finish"].shape[1] // 2
        out["avg_job_latency_us"] = (out["job_finish"][:, :J]
                                     - arrival[:, :J]).mean(dim=1)
        return out
    return f


def _altered(orig):
    """One lane's energy altered where the epilogue produces it."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        out["energy_j"] = out["energy_j"].clone()
        out["energy_j"][0] *= 1.01
        return out
    return f


def _unchanged(orig):
    """The scan returns its state as it found it: nothing committed."""
    def f(*a, **kw):
        out = list(orig(*a, **kw))
        out[1] = out[1].zero_()          # start
        out[2] = out[2].zero_()          # finish
        out[3] = out[3].zero_()          # PE
        return tuple(out)
    return f


@pytest.mark.parametrize("fault", ["half_mean", "altered", "unchanged"])
@pytest.mark.parametrize("cell", ds3bench_tiny.CELLS)
def test_a_broken_timed_path_reads_not_correct(tiny_root, monkeypatch,
                                               cell, fault):
    """The run with the program broken underneath (its scan or epilogue)
    comes out not correct, for each fault a cell can have."""
    from repro_torch.core import simkernel_torch as sk
    from repro_torch.kernels import ops
    if fault == "unchanged":
        _patched(monkeypatch, ops, "epoch_scan", _unchanged)
    else:
        _patched(monkeypatch, sk, "_epilogue",
                 _half_mean if fault == "half_mean" else _altered)
    rc, res, err = _run(tiny_root, cell)
    assert rc == 0 and res["correct"] is False, err


@pytest.mark.parametrize("cell", ds3bench_tiny.CELLS)
def test_the_control_fails_the_limits(tiny_root, cell):
    """The reference computed in bfloat16 times, in the program's place,
    fails the cell's limits; the program passes them on the same lanes."""
    prep = runner.prepare(tiny_root, cell, SEED, "cpu")
    _, outs, _ = runner.timed_calls(prep, 0.0, "cpu")
    limits = prep.cell.limits
    assert check.judge(check.widest(runner.sampled_gaps(prep, outs, SEED)),
                       limits)
    control = check.widest(runner.sampled_gaps(prep, outs, SEED,
                                               precision="bfloat16"))
    assert not check.judge(control, limits)


def test_a_run_loads_no_jax_and_the_reference_no_program(tiny_root):
    """A run (the CPU dry run, in a process of its own) loads no module
    whose top-level name is jax, jaxlib, flax or repro; the reference
    imports nothing of the program."""
    code = (
        "import sys, io, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from ds3bench.harness import runner\n"
        f"rc = runner.run_cell(Path({str(tiny_root)!r}), 'tiny-grid-evaluate',"
        " 5, 0.0, False, device='cpu', out=io.StringIO(), err=io.StringIO())\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'top': top}))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(ROOT))
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "repro_torch" in got["top"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "repro"}
    for path in (ROOT / "ds3bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in {"repro_torch", "repro", "jax",
                                               "torch"}, (path, n)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reproducible_thing", sys)
    assert "repro" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in runner.forbidden_modules()


def test_the_command_refuses_without_a_card_or_the_program(tmp_path):
    """No CUDA card here: the command exits non-zero and prints no result;
    so it does in a directory with only BENCHMARK.json and ds3bench/."""
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "ds3bench", bare / "ds3bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    for where in (ROOT, bare):
        done = subprocess.run(
            [sys.executable, "ds3bench/run.py", "--workload",
             "static-rate-sweep", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=str(where))
        assert done.returncode != 0
        assert done.stdout.strip() == ""


def test_gaps_and_judge():
    class Want:
        avg_latency_us, makespan_us, energy_j = 100.0, 1000.0, 2.0
        peak_temp_c, busy_per_pe_us = 35.0, np.array([10.0, 20.0])
    got = dict(avg_latency_us=101.0, makespan_us=1000.0, energy_j=2.0,
               peak_temp_c=36.0, busy_per_pe_us=np.array([10.0, 21.0, 0.0]))
    g = check.gaps(got, Want)
    assert g == pytest.approx({"latency": 0.01, "makespan": 0.0,
                               "energy": 0.0, "temp": 0.1, "busy": 1e-3})
    lim = {k: 0.05 for k in g}
    assert not check.judge(g, lim)                 # temp over
    assert check.judge(dict(g, temp=0.01), lim)
    assert not check.judge(dict(g, temp=math.nan), lim)
    assert not check.judge({k: v for k, v in g.items() if k != "busy"}, lim)


@pytest.mark.card
def test_a_real_cell_on_the_card():
    """One short run of the first cell on a CUDA card (skips without)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run(
        [sys.executable, "ds3bench/run.py", "--workload", "static-rate-sweep",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert done.returncode == 0, done.stderr[-4000:]
    res = json.loads(done.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
