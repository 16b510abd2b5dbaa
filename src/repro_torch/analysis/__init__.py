"""repro_torch.analysis — static lints of the port's device contracts, and
the launch-count gate.

The twin of ``repro.analysis``: the same engine, CLI, output formats,
waiver policy, severities and gate, with rules that check the port's own
contracts instead of JAX's.  Pure AST: the audited modules are never
imported, and this package imports only the standard library, so linting
needs neither torch nor a card.

* **TX001** host-sync, **TX002** host-numpy — on the hot set
  (:mod:`.reachability`: the step closures, ``Model.decode_step``,
  ``ServeEngine.step``, the simulator's batched entry points and every
  kernel wrapper, never a kernel's ``*_plain`` version)
* **TX003** import-time effects (kernel builds, subprocesses, triton,
  ``os.environ`` writes at module level; builds inside loops)
* **TD001** tensor-carrying dataclasses frozen and not compared by field
* **UN001** unit-suffix discipline on result structs (``--fix``)
* **SC001** loop-step carry stability (arity / order / integer dtype)
* **DN001** in-place writes to values that may alias their source
* **SH001** lane-sharding contracts on ``sharding.P`` and mesh construction
* **KL001** every path to a ctypes kernel launch calls
  ``_build.refuse_grad`` first
* **CC001** launch-count gate over ``BENCH_*.json`` artifacts

Findings carry a severity (``error``/``warn``/``info``): ``error`` gates
every run, ``warn`` gates under ``--strict``, ``info`` never.  Reports emit
as text, JSON, or SARIF 2.1.0.  CLI: ``python -m repro_torch.analysis``;
the configuration defaults are in :mod:`.config` (a
``[tool.repro_torch.analysis]`` table in ``pyproject.toml`` overrides
them); inline waivers are ``# lint: waive CODE -- justification``, the form
both linters share.
"""
from .config import (ALL_RULES, DEFAULT_SEVERITY, RULE_DOCS, AnalysisConfig,
                     load_config)
from .engine import AnalysisReport, changed_files, run_analysis
from .findings import Finding, gating, render_report, report_payload
from .compile_gate import check_compile_gate, load_contracts
from .sarif import render_sarif, sarif_payload

__all__ = [
    "ALL_RULES", "AnalysisConfig", "AnalysisReport", "DEFAULT_SEVERITY",
    "Finding", "RULE_DOCS", "changed_files", "check_compile_gate", "gating",
    "load_config", "load_contracts", "render_report", "render_sarif",
    "report_payload", "run_analysis", "sarif_payload",
]
