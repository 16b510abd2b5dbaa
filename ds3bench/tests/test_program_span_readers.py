"""The readers of the program's spans (``ds3bench/metrics/*_ms_per_call.py``
on ``repro_torch.*`` spans): synthetic traces, then a traced tiny run of
each cell on the CPU.

    PYTHONPATH=src python -m pytest -q ds3bench/tests
"""
from __future__ import annotations

import io
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import ds3bench_tiny  # noqa: E402
from ds3bench.harness import profile, runner, spec  # noqa: E402

SEED = 2 ** 31 + 777
# metric -> the span it reads (the entry's self time reads all six)
READERS = {
    "entry_self_ms_per_call": "repro_torch.entry",
    "tables_host_ms_per_call": "repro_torch.tables",
    "k1_host_ms_per_call": "repro_torch.k1",
    "epilogue_host_ms_per_call": "repro_torch.epilogue",
    "thermal_host_ms_per_call": "repro_torch.thermal",
    "host_wait_ms_per_call": "repro_torch.wait",
}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _run(events):
    s = profile.summarize(events)
    return runner.RunRecord("c", 1.0, s.window_s, [], s)


def _read(name, run):
    return spec._reader(ROOT, name)(run)


# two calls: the first a sweep (tables, K1, epilogue, thermal, wait), the
# second an evaluate's two entries (build_design_batch, then evaluate)
TWO_CALLS = [
    _span("ds3bench.call", 0, 1000),
    _span("repro_torch.entry", 10, 980),
    _span("repro_torch.tables", 20, 100),
    _span("repro_torch.k1", 130, 50),
    _span("repro_torch.epilogue", 190, 30),
    _span("repro_torch.thermal", 230, 500),
    _span("repro_torch.wait", 740, 200),
    {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 240, "dur": 5},
    _span("ds3bench.call", 1000, 1000),
    _span("ds3bench.tables", 1005, 400),
    _span("repro_torch.entry", 1010, 390),
    _span("repro_torch.tables", 1012, 380),
    _span("repro_torch.entry", 1410, 580),
    _span("repro_torch.k1", 1420, 60),
    _span("repro_torch.epilogue", 1490, 40),
    _span("repro_torch.thermal", 1540, 300),
    _span("repro_torch.wait", 1850, 100),
]


def test_each_reader_sums_its_span_over_the_calls():
    run = _run(TWO_CALLS)
    assert run.trace.calls == 2
    want = {"tables_host_ms_per_call": (100 + 380) / 2,
            "k1_host_ms_per_call": (50 + 60) / 2,
            "epilogue_host_ms_per_call": (30 + 40) / 2,
            "thermal_host_ms_per_call": (500 + 300) / 2,
            "host_wait_ms_per_call": (200 + 100) / 2}
    for name, us in want.items():
        assert _read(name, run) == pytest.approx(us * 1e-3)
    # the benchmark's own tables span encloses the program's
    assert _read("tables_ms_per_call", run) == pytest.approx(0.2)


def test_entry_self_time_is_the_entries_less_the_layers():
    run = _run(TWO_CALLS)
    entries = 980 + 390 + 580
    layers = (100 + 50 + 30 + 500 + 200) + (380 + 60 + 40 + 300 + 100)
    assert _read("entry_self_ms_per_call", run) == pytest.approx(
        (entries - layers) / 2 * 1e-3)
    # an entry with no layer inside: all of it is self time
    alone = _run([_span("ds3bench.call", 0, 100),
                  _span("repro_torch.entry", 1, 90)])
    assert _read("entry_self_ms_per_call", alone) == pytest.approx(0.09)
    assert _read("k1_host_ms_per_call", alone) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_an_absent_span_reads_none_never_zero(name):
    span = READERS[name]
    without = [e for e in TWO_CALLS if e["name"] != span]
    assert _read(name, _run(without)) is None
    # the parent's trace: the benchmark's spans and no program span
    parent = [e for e in TWO_CALLS if not e["name"].startswith("repro_torch.")]
    assert _read(name, _run(parent)) is None
    assert _read(name, runner.RunRecord("c", 1.0, 1.0, [], None)) is None
    assert _read(name, _run([])) is None


def test_registered_as_program_spans():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the layers the accepted metrics name, letter for letter
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] not in READERS}
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(got) == set(READERS)
    assert list(got) == [m["name"] for m in bench["per_layer"][-6:]]
    for name, m in got.items():
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["moves"] == "sim_tasks_per_s" and m["layer"] in layers
        assert ("workloads" in m) == (name == "thermal_host_ms_per_call")
    assert got["thermal_host_ms_per_call"]["workloads"] == [
        "static-rate-sweep", "dse-grid-evaluate"]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return ds3bench_tiny.make_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell", sorted(ds3bench_tiny.TINY))
def test_a_traced_tiny_run_prints_the_span_metrics(tiny_root, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run_cell(tiny_root, cell, SEED, 0.0, True, device="cpu",
                         out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], err.getvalue()
    got = {k: v["value"] for k, v in res["metrics"].items() if k in READERS}
    thermal = cell != "tiny-policy-sweep"
    assert set(got) == set(READERS) - (
        set() if thermal else {"thermal_host_ms_per_call"})
    assert all(v >= 0 for v in got.values())
    if cell == "tiny-grid-evaluate":
        assert got["tables_host_ms_per_call"] <= \
            res["metrics"]["tables_ms_per_call"]["value"]
