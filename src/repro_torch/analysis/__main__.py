"""``python -m repro_torch.analysis`` — the port's lint CLI.

The twin of ``python -m repro.analysis``, with the same flags, output
formats and exit codes.  It is static — it parses the sources and imports
none of them, needs neither torch nor a card — so it takes no ``--device``:
the port's rule that entry points default to ``cuda`` concerns code that
runs on a device, and this runs on none.

Examples::

    python -m repro_torch.analysis                # lint the port's paths
    python -m repro_torch.analysis --strict       # warns gate, waivers need a reason
    python -m repro_torch.analysis --changed      # only files vs main
    python -m repro_torch.analysis --select TX001,KL001
    python -m repro_torch.analysis --report findings.json
    python -m repro_torch.analysis --sarif findings.sarif
    python -m repro_torch.analysis --format sarif # SARIF log on stdout
    python -m repro_torch.analysis --fix          # apply UN001 renames
    python -m repro_torch.analysis --compile-gate BENCH_*.json
    python -m repro_torch.analysis --list-rules

Exit status: 0 when no *gating* findings, 1 otherwise, 2 on usage errors.
A finding gates per its severity: ``error`` always, ``warn`` only under
``--strict`` (the CI mode), ``info`` never.  Waived findings print with a
``(waived)`` tag and never gate; ``--strict`` additionally requires every
waiver to carry a ``-- justification`` (WV001).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .compile_gate import check_compile_gate
from .config import ALL_RULES, DEFAULT_SEVERITY, RULE_DOCS, load_config
from .engine import changed_files, run_analysis
from .findings import dump_report, render_report
from .sarif import dump_sarif, render_sarif


def _codes(arg: Optional[str]) -> Optional[List[str]]:
    if not arg:
        return None
    return [c.strip().upper() for c in arg.split(",") if c.strip()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static lints of the port's device contracts + the "
                    "launch-count gate")
    ap.add_argument("files", nargs="*",
                    help="explicit files to lint (default: configured "
                         "paths)")
    ap.add_argument("--strict", action="store_true",
                    help="warn-severity findings gate; waivers must carry "
                         "a justification (WV001)")
    ap.add_argument("--changed", action="store_true",
                    help="lint only files changed vs --base")
    ap.add_argument("--base", default="main",
                    help="git base ref for --changed (default: main)")
    ap.add_argument("--select", metavar="CODES",
                    help="comma-separated rule codes to run exclusively")
    ap.add_argument("--ignore", metavar="CODES",
                    help="comma-separated rule codes to skip")
    ap.add_argument("--report", metavar="PATH",
                    help="write the findings report JSON (CI artifact)")
    ap.add_argument("--sarif", metavar="PATH",
                    help="write a SARIF 2.1.0 log (CI code-scanning "
                         "upload)")
    ap.add_argument("--format", choices=("text", "sarif"), default="text",
                    help="stdout format (default: text)")
    ap.add_argument("--fix", action="store_true",
                    help="mechanically apply UN001 unit-suffix renames "
                         "(definition + call sites), then re-lint")
    ap.add_argument("--root", metavar="DIR", default=None,
                    help="repo root (default: nearest pyproject.toml)")
    ap.add_argument("--compile-gate", nargs="+", metavar="BENCH_JSON",
                    help="run only the CC001 launch-count gate over these "
                         "bench artifacts")
    ap.add_argument("--contracts", metavar="PATH", default=None,
                    help="contracts.json for --compile-gate (default: "
                         "the configured contracts)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule codes, severities and summaries")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in (*ALL_RULES, "WV001"):
            level = DEFAULT_SEVERITY.get(code, "error")
            print(f"{code}  [{level:5s}]  {RULE_DOCS[code]}")
        return 0

    cfg = load_config(Path(args.root) if args.root else None)

    if args.compile_gate:
        contracts = Path(args.contracts) if args.contracts \
            else cfg.root / cfg.contracts
        try:
            findings = check_compile_gate(contracts, args.compile_gate)
        except (OSError, ValueError, KeyError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if findings:
            print(render_report(findings))
            if args.report:
                dump_report(findings, args.report, rules=["CC001"])
            if args.sarif:
                dump_sarif(findings, args.sarif)
            return 1
        print(f"CC001: {len(args.compile_gate)} bench artifact(s) within "
              f"contract ({contracts})")
        if args.report:
            dump_report([], args.report, rules=["CC001"])
        if args.sarif:
            dump_sarif([], args.sarif)
        return 0

    only: Optional[List[str]] = None
    if args.changed:
        only = changed_files(cfg.root, args.base)
        lintable = {p for p in only
                    if any(p.startswith(base) for base in cfg.paths)}
        if not lintable:
            print(f"--changed: no lintable files vs {args.base}")
            return 0
        only = sorted(lintable)
    elif args.files:
        only = args.files

    if args.fix:
        from .fix import apply_fixes, plan_fixes
        from .project import ProjectIndex
        index = ProjectIndex.build(cfg.root, cfg.paths)
        result = apply_fixes(cfg.root, plan_fixes(index, cfg))
        for note in result.skipped:
            print(f"fix: skipped {note}")
        print(f"fix: applied {result.applied} edit(s) across "
              f"{len(result.files)} file(s)")
        # fall through and re-lint the rewritten tree

    try:
        report = run_analysis(cfg, select=_codes(args.select),
                              ignore=_codes(args.ignore),
                              only_paths=only, strict=args.strict)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.report:
        dump_report(report.findings, args.report, rules=list(report.rules),
                    files=report.files)
    if args.sarif:
        dump_sarif(report.findings, args.sarif)
    if args.format == "sarif":
        print(render_sarif(report.findings))
    elif report.findings:
        print(render_report(report.findings))
    else:
        scope = f"{len(only)} changed/selected file(s)" if only \
            else f"{len(report.files)} file(s)"
        print(f"clean: {scope}, rules {','.join(report.rules)}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
