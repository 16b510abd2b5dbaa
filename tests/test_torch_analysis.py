"""repro_torch.analysis — the port's lint suite, linted by its own fixtures
and held against the reference's ``repro.analysis``.

Every rule has a fixture that must trip it (exact codes and lines) and one
that must stay clean (``tests/fixtures/torch_analysis/``, whose
``pyproject.toml`` lists the fixtures' hot-set roots); the CC001 gate runs
over payloads made by the port's own ``obs.bench.rows_payload``.  Where the
two packages share a meaning (UN001, ``--fix``, waivers, report and SARIF
payloads, the config parser, ``changed_files``) both get the same inputs and
must give the same outputs.  The dogfood tests pin the repo to ``--strict``
clean and show that each rule examined the port's own code.
"""
import ast
import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import (check_compile_gate, load_config,
                                  run_analysis)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.engine import changed_files
from repro_torch.analysis.findings import scan_waivers

FIXTURES = Path(__file__).parent / "fixtures" / "torch_analysis"
REF_FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
REPO = Path(__file__).parent.parent
CONTRACTS = REPO / "src" / "repro_torch" / "analysis" / "contracts.json"
WRAPPERS = {"repro_torch.kernels.flash_attention:flash_attention",
            "repro_torch.kernels.decode_attention:decode_attention",
            "repro_torch.kernels.ssd_scan:ssd_scan",
            "repro_torch.kernels.rg_lru:rg_lru",
            "repro_torch.kernels.epoch_scan:epoch_scan",
            "repro_torch.dse.thermal_torch:peak_temperature_grid"}


def lint(*files, strict=False, select=None):
    cfg = dataclasses.replace(load_config(FIXTURES), paths=tuple(files))
    return run_analysis(cfg, select=select, strict=strict)


def lines(findings, code=None):
    return sorted(f.line for f in findings
                  if code is None or f.code == code)


# ---------------------------------------------------------------- TX001

def test_tx001_bad_exact_sites():
    rep = lint("tx001_bad.py", select=["TX001"])
    assert lines(rep.active, "TX001") == [9, 12, 18, 20, 25, 27]
    msgs = {f.line: f.message for f in rep.active}
    assert "`.tolist()`" in msgs[9] and "Engine.step" in msgs[9]
    assert "`float()`" in msgs[12] and "Engine.peak" in msgs[12]
    assert "`if`" in msgs[18] and "decode" in msgs[18]
    assert "`while`" in msgs[25] and "synchronize" in msgs[27]


def test_tx001_good_is_clean():
    rep = lint("tx001_good.py", select=["TX001"])
    assert rep.active == []
    assert rep.examined["TX001"]           # it looked


# ---------------------------------------------------------------- TX002

def test_tx002_bad_flags_and_waives():
    rep = lint("tx002_bad.py", select=["TX002"])
    assert lines(rep.active, "TX002") == [7]
    waived = [f for f in rep.findings if f.waived]
    assert lines(waived, "TX002") == [12]
    assert waived[0].waiver_reason.startswith("fixture:")


def test_tx002_good_side_of_boundary():
    # tx001_good feeds numpy a value an isinstance check proved host-side
    rep = lint("tx001_good.py", select=["TX002"])
    assert rep.active == []
    assert rep.examined["TX002"]


# ---------------------------------------------------------------- TX003

def test_tx003_bad_exact_sites():
    rep = lint("tx003_bad.py", select=["TX003"])
    assert lines(rep.active, "TX003") == [5, 9, 10, 11, 15]
    msgs = {f.line: f.message for f in rep.active}
    assert "triton" in msgs[5] and "os.environ" in msgs[9]
    assert "build" in msgs[10] and "subprocess" in msgs[11]
    assert "loop" in msgs[15]


def test_tx003_good_deferred_effects_and_waiver():
    rep = lint("tx003_good.py", select=["TX003"])
    assert rep.active == []
    assert lines([f for f in rep.findings if f.waived], "TX003") == [18]


# ---------------------------------------------------------------- TD001

def test_td001_bad_exact_sites():
    rep = lint("td001_bad.py", select=["TD001"])
    assert lines(rep.active, "TD001") == [9, 14, 20, 26, 26]
    msgs = [(f.line, f.message) for f in rep.active]
    assert any(line == 9 and "frozen" in m for line, m in msgs)
    assert any(line == 14 and "__eq__" in m for line, m in msgs)
    assert any(line == 20 and "['y']" in m for line, m in msgs)


def test_td001_good_eq_false_and_compare_false():
    rep = lint("td001_good.py", select=["TD001"])
    assert rep.active == []
    assert len(rep.examined["TD001"]) == 2   # Plain holds no tensor


# ---------------------------------------------------------------- UN001

def test_un001_bad_fields_and_payload_keys():
    rep = lint("un001_bad.py", select=["UN001"])
    assert lines(rep.active, "UN001") == [10, 12, 13, 17]


def test_un001_good_suffixes_and_allowlist():
    rep = lint("un001_good.py", select=["UN001"])
    assert rep.active == []


# ---------------------------------------------------------------- SC001

def test_sc001_bad_exact_sites():
    rep = lint("sc001_bad.py", select=["SC001"])
    assert lines(rep.active, "SC001") == [6, 17, 28, 39, 50, 62]
    msgs = {f.line: f.message for f in rep.active}
    assert "arity diverges" in msgs[6]
    assert "reordered" in msgs[17]
    assert "true division" in msgs[28]
    assert ".mean()" in msgs[39]
    assert "cast to <int>" in msgs[50]
    assert "return paths" in msgs[62]


def test_sc001_good_is_clean():
    # floor division, a float init, a cast on every path, a method and a
    # nested def as the step, an opaque return: all stable
    rep = lint("sc001_good.py", select=["SC001"])
    assert rep.active == []
    assert len(rep.examined["SC001"]) == 6


# ---------------------------------------------------------------- DN001

def test_dn001_bad_exact_sites():
    rep = lint("dn001_bad.py", select=["DN001"])
    assert lines(rep.active, "DN001") == [7, 14, 20, 26, 32]
    for f in rep.active:
        assert "in place" in f.message and "copy=True" in f.message


def test_dn001_good_is_clean():
    # copy=True, .clone(), a rebind, writes through views and parameters,
    # fresh buffers: nothing aliases
    rep = lint("dn001_good.py", select=["DN001"])
    assert rep.active == []
    assert rep.examined["DN001"]


# ---------------------------------------------------------------- SH001

def test_sh001_bad_exact_sites():
    rep = lint("sh001_bad.py", select=["SH001"])
    assert lines(rep.active, "SH001") == [6, 10, 14, 20, 21]
    msgs = {f.line: f.message for f in rep.active}
    assert "leading axis" in msgs[6]
    assert "lane_mesh" in msgs[14] and "hot" in msgs[14]
    assert "launch.mesh" in msgs[21]


def test_sh001_good_is_clean():
    rep = lint("sh001_good.py", select=["SH001"])
    assert rep.active == []


# ---------------------------------------------------------------- KL001

def test_kl001_bad_exact_sites():
    rep = lint("kl001_bad.py", select=["KL001"])
    assert lines(rep.active, "KL001") == [19, 23, 29]
    assert all("refuse_grad" in f.message for f in rep.active)


def test_kl001_good_refuse_grad_or_no_grad():
    rep = lint("kl001_good.py", select=["KL001"])
    assert rep.active == []
    assert rep.examined["KL001"] == ["kl001_good:toy", "kl001_good:toy_serving",
                                     "kl001_good:toy_block"]


def test_kl001_private_launcher_called_from_elsewhere():
    rep = lint("kl001_good.py", "kl001_tool.py", select=["KL001"])
    assert [(f.path, f.line) for f in rep.active] == [("kl001_tool.py", 6)]


# ---------------------------------------------------------------- severity

def test_severity_defaults_warn_gates_only_strict():
    rep = lint("sh001_bad.py", select=["SH001"])
    assert rep.active and all(f.severity == "warn" for f in rep.active)
    assert rep.ok                          # warns pass a default run
    rep = lint("sh001_bad.py", select=["SH001"], strict=True)
    assert not rep.ok                      # --strict promotes warns


def test_severity_overrides_change_gating():
    base = load_config(FIXTURES)
    cfg = dataclasses.replace(base, paths=("sh001_bad.py",),
                              severity=(("SH001", "error"),))
    assert not run_analysis(cfg, select=["SH001"]).ok
    cfg = dataclasses.replace(base, paths=("sc001_bad.py",),
                              severity=(("SC001", "info"),))
    rep = run_analysis(cfg, select=["SC001"], strict=True)
    assert rep.active and rep.ok           # info prints, never gates


def test_severity_config_parsing():
    from repro_torch.analysis.config import _parse_severity
    assert _parse_severity(["SH001=error"]) == (("SH001", "error"),)
    assert _parse_severity({"KL001": "info"}) == (("KL001", "info"),)
    with pytest.raises(ValueError):
        _parse_severity(["JX001=warn"])    # the reference's code, not ours
    with pytest.raises(ValueError):
        _parse_severity(["SH001=loud"])


def test_finding_render_uses_severity_word():
    rep = lint("sh001_bad.py", select=["SH001"])
    assert "SH001 warning:" in rep.active[0].render()
    rep = lint("tx001_bad.py", select=["TX001"])
    assert "TX001 error:" in rep.active[0].render()


def test_report_payload_counts_per_severity():
    from repro_torch.analysis.findings import report_payload
    rep = lint("sh001_bad.py", select=["SH001"])
    payload = report_payload(rep.findings)
    assert payload["summary"]["per_severity"] == {"warn": 5}


# ---------------------------------------------------------------- waivers

def test_waiver_scanning_forms():
    src = ("x = 1  # lint: waive TX001 -- same line\n"
           "# lint: waive UN001,TD001 -- next line\n"
           "y = 2\n")
    w = scan_waivers(src)
    assert w[1].codes == {"TX001"}
    assert w[2].codes == w[3].codes == {"UN001", "TD001"}
    assert w[3].reason == "next line"


def test_waiver_multi_code_trailing():
    src = "y = f()  # lint: waive TX003,KL001 -- a program, no grad\n"
    w = scan_waivers(src)
    assert w[1].codes == {"TX003", "KL001"}


def test_waiver_standalone_above_decorated_def():
    src = ("import dataclasses\n"
           "# lint: waive TD001 -- fixture: covers the class line too\n"
           "@dataclasses.dataclass\n"
           "class C:\n"
           "    x: int = 0\n")
    w = scan_waivers(src, ast.parse(src))
    assert 2 in w and 3 in w               # comment + first decorator line
    assert 4 in w and w[4].codes == {"TD001"}   # the class line itself
    w_plain = scan_waivers(src)
    assert 3 in w_plain and 4 not in w_plain


def test_waiver_on_continuation_line():
    src = ("x = (1 +\n"
           "     2)  # lint: waive UN001 -- fixture: continuation\n")
    w = scan_waivers(src, ast.parse(src))
    assert 2 in w
    assert 1 in w and w[1].codes == {"UN001"}   # the statement's lineno
    assert 1 not in scan_waivers(src)


def test_wv001_only_in_strict():
    rep = lint("wv001_bad.py", select=["TX002"])
    assert rep.active == []                      # waiver applies
    rep = lint("wv001_bad.py", select=["TX002"], strict=True)
    assert [f.code for f in rep.active] == ["WV001"]


# ---------------------------------------------------------------- CC001

def _bench_payload(monkeypatch, bench, k1=None, scans=None):
    """``obs.bench.rows_payload`` with K1's launch counters and the sweep's
    scan counters set to the given counts (by instantiation name)."""
    from repro_torch.kernels import epoch_scan
    from repro_torch.obs.bench import rows_payload
    sweep_mod = importlib.import_module("repro_torch.scenario.sweep")
    key_of = {name: key for key, name in epoch_scan.VARIANT_NAMES.items()}
    for counts, store in ((k1 or {}, epoch_scan.variant_launches),
                          (scans or {}, sweep_mod.scan_calls)):
        for key in store:
            monkeypatch.setitem(store, key, 0)
        for name, n in counts.items():
            monkeypatch.setitem(store, key_of[name], n)
    return rows_payload([("points_per_s", 1.0, "")], bench, 0.5,
                        device="cpu")


def _write(tmp_path, name, payload):
    p = tmp_path / name
    p.write_text(json.dumps(payload))
    return p


def _contract(tmp_path, contracts):
    return _write(tmp_path, "contracts.json", {
        "schema": "repro_torch.analysis/contracts/v1",
        "contracts": contracts})


def test_cc001_within_contract(tmp_path, monkeypatch):
    contracts = _contract(tmp_path, {"sweep": {
        "k1_launches.epoch_scan": 1, "scan_calls.epoch_scan": 1}})
    art = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 1},
        scans={"epoch_scan": 1}))
    assert check_compile_gate(contracts, [art]) == []


def test_cc001_deliberate_violation_fails_gate(tmp_path, monkeypatch):
    # a sweep that launched K1 once per lane instead of once per grid
    contracts = _contract(tmp_path, {"sweep": {
        "k1_launches.epoch_scan": 1, "scan_calls.epoch_scan": 1}})
    art = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 64},
        scans={"epoch_scan": 1}))
    findings = check_compile_gate(contracts, [art])
    assert len(findings) == 1
    assert findings[0].code == "CC001"
    assert "k1_launches.epoch_scan" in findings[0].message


def test_cc001_patched_contract_tightens(tmp_path, monkeypatch):
    patched = _contract(tmp_path, {"sweep": {"scan_calls.epoch_scan": 0}})
    art = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", scans={"epoch_scan": 1}))
    findings = check_compile_gate(patched, [art])
    assert [f.code for f in findings] == ["CC001"]


def test_cc001_unknown_bench_and_stray_counter(tmp_path, monkeypatch):
    patched = _contract(tmp_path, {"sweep": {}})
    unknown = _write(tmp_path, "BENCH_new.json",
                     _bench_payload(monkeypatch, "brand_new"))
    stray = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan_dtpm": 2}))
    msgs = [f.message for f in check_compile_gate(patched, [unknown, stray])]
    assert any("no launch-count contract" in m for m in msgs)
    assert any("not in the contract" in m for m in msgs)
    # the checked-in map is empty: every bench is unregistered until a
    # benchmark registers its budget
    assert json.loads(CONTRACTS.read_text())["contracts"] == {}
    msgs = [f.message for f in check_compile_gate(CONTRACTS, [stray])]
    assert len(msgs) == 1 and "no launch-count contract" in msgs[0]


def test_cc001_pytest_plugin_flips_exit_status(tmp_path, monkeypatch):
    from repro_torch.analysis import pytest_plugin
    patched = _contract(tmp_path, {"sweep": {"k1_launches.epoch_scan": 0}})
    _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 3}))
    monkeypatch.chdir(tmp_path)

    class _Config:
        def __init__(self):
            self.pluginmanager = types.SimpleNamespace(
                get_plugin=lambda name: None)

        def getoption(self, name):
            return {"--launch-contracts": str(patched),
                    "--launch-bench": "BENCH_*.json"}[name]

    session = types.SimpleNamespace(config=_Config(), exitstatus=0)
    pytest_plugin.pytest_sessionfinish(session, 0)
    assert session.exitstatus == 1


def test_both_pytest_plugins_register_their_options_together():
    from repro.analysis import pytest_plugin as ref_plugin
    from repro_torch.analysis import pytest_plugin

    class _Parser:
        """Records what each plugin registers, refusing a repeated option
        as pytest's own parser does."""

        def __init__(self):
            self.options = {}

        def getgroup(self, name):
            return types.SimpleNamespace(addoption=lambda opt, **kw: (
                self.options.__setitem__(opt, (name, kw["default"]))
                if opt not in self.options else
                pytest.fail(f"{opt} registered twice")))

    parser = _Parser()
    ref_plugin.pytest_addoption(parser)
    pytest_plugin.pytest_addoption(parser)
    assert parser.options == {
        "--compile-contracts": ("repro.analysis", None),
        "--compile-bench": ("repro.analysis", "BENCH_*.json"),
        "--launch-contracts": ("repro_torch.analysis", None),
        "--launch-bench": ("repro_torch.analysis", "BENCH_*.json")}


# ---------------------------------------------------------------- CLI

def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ("TX001", "TX002", "TX003", "TD001", "UN001",
                 "SC001", "DN001", "SH001", "KL001", "CC001", "WV001"):
        assert code in out
    assert "[warn" in out                  # SH001's default severity shows


def test_cli_exit_codes_and_report(tmp_path, capsys):
    report = tmp_path / "findings.json"
    rc = cli_main(["--root", str(FIXTURES), "--select", "TX001",
                   "--report", str(report), "tx001_bad.py"])
    assert rc == 1
    payload = json.loads(report.read_text())
    assert payload["schema"] == "repro_torch.analysis/report/v1"
    assert payload["summary"]["per_code"]["TX001"] == 6
    rc = cli_main(["--root", str(FIXTURES), "--select", "TX001",
                   "tx001_good.py"])
    assert rc == 0


def test_cli_unknown_rule_is_usage_error(capsys):
    assert cli_main(["--select", "ZZ999"]) == 2
    assert cli_main(["--select", "JX001"]) == 2     # the reference's code


def test_cli_compile_gate(tmp_path, monkeypatch, capsys):
    art = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 99}))
    assert cli_main(["--compile-gate", str(art)]) == 1   # unregistered
    contracts = _contract(tmp_path, {"sweep": {"k1_launches.epoch_scan": 1}})
    assert cli_main(["--compile-gate", str(art),
                     "--contracts", str(contracts)]) == 1
    ok = _write(tmp_path, "ok.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 1}))
    assert cli_main(["--compile-gate", str(ok),
                     "--contracts", str(contracts)]) == 0


def test_changed_files_runs(tmp_path):
    # no git in tmp_path: must degrade to an empty list, not raise
    assert changed_files(tmp_path) == []
    assert isinstance(changed_files(REPO), list)


# ---------------------------------------------------------------- --fix

def _seed_fix_tree(tmp_path):
    shutil.copy(FIXTURES / "fix_un001.py", tmp_path / "fix_un001.py")
    (tmp_path / "pyproject.toml").write_text(
        '[tool.repro_torch.analysis]\npaths = ["fix_un001.py"]\n')
    return tmp_path


def _exec_summarize(path):
    ns = {}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns["summarize"](2.0)


def test_fix_applies_un001_renames(tmp_path, capsys):
    root = _seed_fix_tree(tmp_path)
    assert cli_main(["--root", str(root), "--select", "UN001"]) == 1
    assert cli_main(["--root", str(root), "--fix",
                     "--select", "UN001"]) == 0
    src = (root / "fix_un001.py").read_text()
    assert "energy_j: float" in src
    assert "power_w: float" in src
    assert "latency_us: float" in src
    assert '"latency_us"' in src               # dict keys follow the field
    assert "EnergyReport(energy_j=1.0" in src  # constructor call site
    assert "rep.energy_j" in src               # inferred attribute read
    assert "num_jobs: int" in src              # allow-listed name untouched


def test_fix_is_idempotent_and_behavior_preserving(tmp_path, capsys):
    root = _seed_fix_tree(tmp_path)
    before = _exec_summarize(root / "fix_un001.py")
    assert cli_main(["--root", str(root), "--fix",
                     "--select", "UN001"]) == 0
    first = (root / "fix_un001.py").read_text()
    capsys.readouterr()
    assert cli_main(["--root", str(root), "--fix",
                     "--select", "UN001"]) == 0
    assert (root / "fix_un001.py").read_text() == first
    assert "applied 0 edit(s)" in capsys.readouterr().out
    assert _exec_summarize(root / "fix_un001.py") == before


def test_fix_skips_waived_sites(tmp_path):
    root = _seed_fix_tree(tmp_path)
    src = (root / "fix_un001.py").read_text().replace(
        "    energy: float",
        "    # lint: waive UN001 -- fixture: stays dimensionless\n"
        "    energy: float")
    (root / "fix_un001.py").write_text(src)
    from repro_torch.analysis.fix import apply_fixes, plan_fixes
    from repro_torch.analysis.project import ProjectIndex
    cfg = load_config(root)
    result = apply_fixes(root, plan_fixes(
        ProjectIndex.build(root, cfg.paths), cfg))
    fixed = (root / "fix_un001.py").read_text()
    assert "    energy: float" in fixed        # waived field kept
    assert "power_w: float" in fixed           # the others still fixed
    assert any("waived" in note for note in result.skipped)


# ---------------------------------------------------------------- SARIF

def test_sarif_shape_and_suppressions(tmp_path):
    sarif = tmp_path / "findings.sarif"
    rc = cli_main(["--root", str(FIXTURES), "--select", "TX002",
                   "--sarif", str(sarif), "tx002_bad.py"])
    assert rc == 1
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0"
    assert "sarif-schema-2.1.0" in log["$schema"]
    run = log["runs"][0]
    assert run["tool"]["driver"]["name"] == "repro_torch.analysis"
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert {"TX001", "TD001", "UN001", "SC001", "DN001", "SH001",
            "KL001"} <= set(rule_ids)
    results = run["results"]
    assert len(results) == 2                   # one active + one waived
    active = [r for r in results if "suppressions" not in r]
    waived = [r for r in results if "suppressions" in r]
    assert len(active) == 1 and len(waived) == 1
    assert active[0]["ruleId"] == "TX002"
    assert active[0]["level"] == "error"
    loc = active[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "tx002_bad.py"
    assert loc["region"]["startLine"] == 7
    assert loc["region"]["startColumn"] >= 1
    sup = waived[0]["suppressions"][0]
    assert sup["kind"] == "inSource"
    assert sup["justification"].startswith("fixture:")


def test_sarif_levels_follow_severity():
    from repro_torch.analysis.sarif import sarif_payload
    rep = lint("sh001_bad.py", select=["SH001"])
    log = sarif_payload(rep.findings)
    levels = {r["level"] for r in log["runs"][0]["results"]}
    assert levels == {"warning"}               # SH001 defaults to warn


def test_cli_format_sarif_stdout(capsys):
    rc = cli_main(["--root", str(FIXTURES), "--select", "TX001",
                   "--format", "sarif", "tx001_bad.py"])
    assert rc == 1
    log = json.loads(capsys.readouterr().out)
    assert log["version"] == "2.1.0"
    assert len(log["runs"][0]["results"]) == 6


# ---------------------------------------------------------- changed-files

def _git(tmp, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *args], cwd=tmp, check=True, capture_output=True)


def _rename_repo(tmp_path):
    """A git repo with a pure rename, then an edit of the renamed file, an
    added file, a deletion and an untracked file; returns the base."""
    _git(tmp_path, "init", "-q")
    (tmp_path / "mod_a.py").write_text("VALUE = 1\n" * 20)
    (tmp_path / "gone.py").write_text("X = 1\n")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    base = subprocess.run(["git", "rev-parse", "HEAD"], cwd=tmp_path,
                          capture_output=True, text=True).stdout.strip()
    _git(tmp_path, "mv", "mod_a.py", "mod_b.py")
    _git(tmp_path, "commit", "-qm", "rename")
    return base


def test_changed_files_resolves_renames(tmp_path):
    base = _rename_repo(tmp_path)
    # a pure rename (R100) is content-identical to the base: nothing to lint
    assert changed_files(tmp_path, base) == []
    (tmp_path / "mod_b.py").write_text("VALUE = 1\n" * 20 + "EXTRA = 2\n")
    _git(tmp_path, "commit", "-aqm", "edit")
    # rename + edit lints the new path only — never the vanished old one
    assert changed_files(tmp_path, base) == ["mod_b.py"]


def test_cc001_message_names_bench_counter_and_delta(tmp_path, monkeypatch):
    patched = _contract(tmp_path, {"sweep": {"k1_launches.epoch_scan": 1}})
    art = _write(tmp_path, "BENCH_sweep.json", _bench_payload(
        monkeypatch, "sweep", k1={"epoch_scan": 64}))
    msg = check_compile_gate(patched, [art])[0].message
    assert "benchmark `sweep`" in msg
    assert "`k1_launches.epoch_scan`" in msg
    assert "hit 64 launches, contract allows 1" in msg
    assert "+63 over budget" in msg


# ---------------------------------------------------------------- dogfood

@pytest.fixture(scope="module")
def repo_report():
    return run_analysis(load_config(REPO), ignore=["CC001"], strict=True)


def test_repo_is_strict_clean(repo_report):
    rep = repo_report
    assert rep.active == [], "\n".join(f.render() for f in rep.active)
    waived = [f for f in rep.findings if f.waived]
    assert waived and all(f.waiver_reason for f in waived)
    # the serving engine's one sync a tick stays visible, not silenced
    assert any(f.code == "TX001" and f.path == "src/repro_torch/serving/"
               "engine.py" and "ServeEngine.step" in f.message
               for f in waived)
    # K1's launch carries its reason: its inputs never require grad
    assert any(f.code == "KL001" and "epoch_scan.py" in f.path
               for f in waived)


def test_repo_rules_examined_the_port(repo_report):
    """Nothing passes vacuously: each rule looked at sites of the port."""
    ex = repo_report.examined
    for code in ("TX001", "TX002", "SC001", "DN001", "KL001", "TD001"):
        assert any(s.startswith(("src/repro_torch/", "repro_torch."))
                   for s in ex.get(code, ())), (code, ex.get(code))
    assert WRAPPERS <= set(ex["KL001"])
    assert "src/repro_torch/core/simkernel_torch.py:70" in ex["TD001"]


def test_repo_hot_set_covers_kernels(repo_report):
    hot = repo_report.hot
    assert hot.missing == [], hot.missing
    names = {(u.mod.module, u.name) for u in hot}
    for expected in (
            ("repro_torch.launch.steps", "make_train_step.<locals>.train_step"),
            ("repro_torch.launch.steps",
             "make_train_step.<locals>.value_and_grad"),
            ("repro_torch.launch.steps", "make_serve_step.<locals>.serve_step"),
            ("repro_torch.models.model", "Model.decode_step"),
            ("repro_torch.serving.engine", "ServeEngine.step"),
            ("repro_torch.core.simkernel_torch", "simulate_batch_dtpm"),
            ("repro_torch.dse.batch", "simulate_grid"),
            ("repro_torch.scenario.shardexec", "grid_program"),
            ("repro_torch.dse.thermal_torch", "peak_temperature_grid"),
            # callees across modules: the decode path below decode_step
            ("repro_torch.models.transformer", "decode_stack"),
            ("repro_torch.models.attention", "decode_self_attention"),
            ("repro_torch.kernels.ops", "decode_attention"),
            ("repro_torch.optim.adamw", "adamw_update")):
        assert expected in names, expected
    for spec in WRAPPERS:
        assert tuple(spec.split(":")) in names
    # never a kernel's plain version, nor K1's oracle carry
    assert not any(n.endswith("_plain") or n.startswith("_Windows")
                   for _, n in names), sorted(names)


def test_both_linters_strict_clean_in_subprocesses():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ref = subprocess.run([sys.executable, "-m", "repro.analysis", "--strict"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--strict'])\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m]), 'jax'\n"
            "sys.exit(rc)\n")
    port = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert port.returncode == 0, port.stdout[-2000:] + port.stderr[-2000:]
    assert "0 finding(s)" in port.stdout


# ------------------------------------------- held against the reference

def _ref(name):
    return importlib.import_module(f"repro.analysis.{name}")


def _port(name):
    return importlib.import_module(f"repro_torch.analysis.{name}")


def _as_tuples(findings):
    return [(f.code, f.path, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("fixture", ["un001_bad.py", "un001_good.py"])
def test_un001_matches_the_reference(fixture):
    got = run_analysis(AnalysisConfig(root=REF_FIXTURES, paths=(fixture,)),
                       select=["UN001"])
    ref_cfg = _ref("config").AnalysisConfig(root=REF_FIXTURES,
                                            paths=(fixture,))
    want = ref_analysis.run_analysis(ref_cfg, select=["UN001"])
    assert _as_tuples(got.findings) == _as_tuples(want.findings)
    assert (fixture == "un001_good.py") == (got.findings == [])


def test_fix_matches_the_reference_byte_for_byte(tmp_path):
    out = {}
    for name, pkg in (("ref", "repro.analysis"),
                      ("port", "repro_torch.analysis")):
        root = tmp_path / name
        root.mkdir()
        shutil.copy(REF_FIXTURES / "fix_un001.py", root / "fix_un001.py")
        cfg = importlib.import_module(f"{pkg}.config").AnalysisConfig(
            root=root, paths=("fix_un001.py",))
        fix = importlib.import_module(f"{pkg}.fix")
        index = importlib.import_module(f"{pkg}.project").ProjectIndex.build(
            root, cfg.paths)
        result = fix.apply_fixes(root, fix.plan_fixes(index, cfg))
        out[name] = ((root / "fix_un001.py").read_bytes(), result.applied)
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0


def test_waiver_scans_match_the_reference():
    for path in sorted(REF_FIXTURES.glob("*.py")):
        src = path.read_text()
        tree = ast.parse(src)
        got = {k: (sorted(w.codes), w.reason, w.line)
               for k, w in scan_waivers(src, tree).items()}
        want = {k: (sorted(w.codes), w.reason, w.line)
                for k, w in _ref("findings").scan_waivers(src, tree).items()}
        assert got == want, path.name


def test_wv001_matches_the_reference():
    findings = []
    for pkg in (ref_analysis, importlib.import_module("repro_torch.analysis")):
        cfg = importlib.import_module(f"{pkg.__name__}.config") \
            .AnalysisConfig(root=REF_FIXTURES, paths=("wv001_bad.py",))
        rep = pkg.run_analysis(cfg, select=["UN001"], strict=True)
        findings.append(_as_tuples(f for f in rep.findings
                                   if f.code == "WV001"))
    assert findings[0] == findings[1] and len(findings[0]) == 1


def _fixed_findings(pkg):
    finding = importlib.import_module(f"{pkg}.findings").Finding
    return [finding(code="UN001", path="a.py", line=3, col=4,
                    message="m", severity="error"),
            finding(code="SH001", path="b.py", line=1, message="w",
                    severity="warn", waived=True, waiver_reason="why"),
            finding(code="WV001", path="a.py", line=9, message="n",
                    severity="info")]


def test_report_and_sarif_payloads_match_the_reference():
    ref, port = _fixed_findings("repro.analysis"), \
        _fixed_findings("repro_torch.analysis")
    got = _port("findings").report_payload(port, extra=1)
    want = _ref("findings").report_payload(ref, extra=1)
    assert got.pop("schema") == "repro_torch.analysis/report/v1"
    assert want.pop("schema") == "repro.analysis/report/v1"
    assert got == want

    def strip(log):
        driver = log["runs"][0]["tool"]["driver"]
        name = driver.pop("name")
        driver.pop("rules")
        for r in log["runs"][0]["results"]:
            r.pop("ruleIndex", None)
        return name, log

    got_name, got = strip(_port("sarif").sarif_payload(port))
    want_name, want = strip(_ref("sarif").sarif_payload(ref))
    assert (got_name, want_name) == ("repro_torch.analysis", "repro.analysis")
    assert got == want


def test_config_parsers_match_the_reference():
    text = (REPO / "pyproject.toml").read_text()
    ref_cfg, port_cfg = _ref("config"), _port("config")
    for section in ("tool.repro.analysis", "tool.repro_torch.analysis"):
        assert port_cfg._parse_section(text, section) == \
            ref_cfg._parse_section(text, section)
    assert port_cfg._parse_toml(text) == ref_cfg._parse_toml(text)
    # the repo has no [tool.repro_torch.analysis] table: the defaults rule
    assert load_config(REPO) == AnalysisConfig(root=REPO.resolve())


def test_changed_files_matches_the_reference(tmp_path):
    base = _rename_repo(tmp_path)
    (tmp_path / "mod_b.py").write_text("VALUE = 1\n" * 20 + "EXTRA = 2\n")
    (tmp_path / "new.py").write_text("Y = 2\n")
    _git(tmp_path, "add", "new.py")
    _git(tmp_path, "rm", "-q", "gone.py")
    _git(tmp_path, "commit", "-aqm", "edit")
    (tmp_path / "untracked.py").write_text("Z = 3\n")
    got = changed_files(tmp_path, base)
    assert got == _ref("engine").changed_files(tmp_path, base)
    assert got == ["mod_b.py", "new.py", "untracked.py"]
