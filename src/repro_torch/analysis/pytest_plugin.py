"""Pytest hook for the CC001 counter gate.

The twin of ``src/repro/analysis/pytest_plugin.py``, with option names and a
group of its own (``--launch-contracts``, ``--launch-bench``) so that both
plugins can be loaded in one session.  Load it with ``-p
repro_torch.analysis.pytest_plugin`` and point it at the artifacts::

    pytest -p repro_torch.analysis.pytest_plugin \\
        --launch-contracts src/repro_torch/analysis/contracts.json \\
        --launch-bench 'BENCH_*.json'

After the test session the gate runs over every matching ``BENCH_*.json``;
violations print as lint findings and flip the session exit status to 1, so
a launch-count regression fails CI even when every test passed.
"""
from __future__ import annotations

import glob
from pathlib import Path


def pytest_addoption(parser):
    group = parser.getgroup("repro_torch.analysis")
    group.addoption("--launch-contracts", default=None, metavar="PATH",
                    help="contracts.json for the port's CC001 launch-count "
                         "gate")
    group.addoption("--launch-bench", default="BENCH_*.json",
                    metavar="GLOB",
                    help="glob of bench artifacts to gate "
                         "(default: BENCH_*.json)")


def pytest_sessionfinish(session, exitstatus):
    contracts = session.config.getoption("--launch-contracts")
    if not contracts:
        return
    from .compile_gate import check_compile_gate
    pattern = session.config.getoption("--launch-bench")
    bench_paths = sorted(Path(p) for p in glob.glob(pattern))
    tr = session.config.pluginmanager.get_plugin("terminalreporter")

    def say(line):
        if tr is not None:
            tr.write_line(line)
        else:                                             # pragma: no cover
            print(line)

    if not bench_paths:
        say(f"[repro_torch.analysis] CC001: no bench artifacts match "
            f"{pattern!r}; gate skipped")
        return
    findings = check_compile_gate(Path(contracts), bench_paths)
    if findings:
        for f in findings:
            say(f.render())
        say(f"[repro_torch.analysis] CC001: {len(findings)} launch-count "
            f"violation(s)")
        session.exitstatus = 1
    else:
        say(f"[repro_torch.analysis] CC001: {len(bench_paths)} bench "
            f"artifact(s) within contract")
