"""Orchestrator: index → hot set → rules → waivers → severity → report.

The twin of ``src/repro/analysis/engine.py``, in the same order and with the
same ``only_paths`` semantics: the full project index is always built (even
under ``--changed``) so that the hot set and import resolution stay
whole-program; ``only_paths`` then filters which files may *report*
findings.  Nothing in the audited tree is imported — see
:mod:`repro_torch.analysis.project`.

Severity is assigned *after* waivers: every finding carries its configured
level, and :attr:`AnalysisReport.ok` gates on
:func:`repro_torch.analysis.findings.gating` — ``error`` always fails the
run, ``warn`` only under ``--strict``, ``info`` never.

Beyond the reference, the report counts the sites each rule examined
(:attr:`AnalysisReport.examined`: rule -> ``path:line`` or
``module:function`` labels), so a rule that finds nothing shows that it
looked.
"""
from __future__ import annotations

import dataclasses
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .config import AnalysisConfig
from .findings import Finding, apply_waivers, gating, scan_waivers
from .project import ProjectIndex
from .reachability import ReachableSet, compute_reachable
from .rules_inplace import check_inplace_rules
from .rules_loops import check_loop_rules
from .rules_sharding import check_sharding_rules
from .rules_tensors import check_tensor_rules
from .rules_torch import (check_hot_rules, check_import_rules,
                          check_launch_rules)
from .rules_units import check_unit_rules


@dataclasses.dataclass
class AnalysisReport:
    findings: List[Finding]
    rules: Tuple[str, ...]
    files: List[str]                    # every file indexed
    strict: bool = False
    examined: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    hot: Optional[ReachableSet] = None

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def gating(self) -> List[Finding]:
        return gating(self.findings, strict=self.strict)

    @property
    def ok(self) -> bool:
        return not self.gating


def run_analysis(cfg: AnalysisConfig,
                 select: Optional[Sequence[str]] = None,
                 ignore: Optional[Sequence[str]] = None,
                 only_paths: Optional[Sequence[str]] = None,
                 strict: bool = False) -> AnalysisReport:
    rules = cfg.enabled_rules(list(select) if select else None,
                              list(ignore) if ignore else None)
    index = ProjectIndex.build(cfg.root, cfg.paths)
    if only_paths is not None:        # explicit files may sit off cfg.paths
        for p in only_paths:
            fp = Path(p) if Path(p).is_absolute() else Path(cfg.root) / p
            if fp.suffix == ".py" and fp.is_file():
                index.add_file(fp)

    findings: List[Finding] = []
    examined: Dict[str, List[str]] = {}
    hot_rules = [r for r in rules if r in ("TX001", "TX002")]
    reach = None
    if hot_rules or "SH001" in rules:
        reach = compute_reachable(index, cfg.hot_roots, cfg.hot_exclude)
    if hot_rules:
        findings += check_hot_rules(reach, hot_rules, examined)
    if "TX003" in rules:
        findings += check_import_rules(index, examined)
    if "TD001" in rules:
        findings += check_tensor_rules(index, examined)
    if "UN001" in rules:
        findings += check_unit_rules(index, cfg)
    if "SC001" in rules:
        findings += check_loop_rules(index, examined)
    if "DN001" in rules:
        findings += check_inplace_rules(index, examined)
    if "SH001" in rules:
        findings += check_sharding_rules(index, reach, examined)
    if "KL001" in rules:
        findings += check_launch_rules(index, examined)

    if only_paths is not None:
        keep = {_norm(cfg.root, p) for p in only_paths}
        findings = [f for f in findings if f.path in keep]

    waivers = {mod.path: w for mod in index.modules.values()
               if (w := scan_waivers(mod.source, mod.tree))}
    if only_paths is not None:
        keep = {_norm(cfg.root, p) for p in only_paths}
        waivers = {p: w for p, w in waivers.items() if p in keep}
    findings = apply_waivers(findings, waivers, strict=strict)
    findings = [dataclasses.replace(f, severity=cfg.severity_for(f.code))
                for f in findings]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return AnalysisReport(findings=findings, rules=rules,
                          files=sorted(index.by_path), strict=strict,
                          examined=examined, hot=reach)


def _norm(root: Path, path: str) -> str:
    p = Path(path)
    if p.is_absolute():
        try:
            return p.resolve().relative_to(Path(root).resolve()).as_posix()
        except ValueError:
            return p.as_posix()
    return p.as_posix()


def changed_files(root: Path, base: str = "main") -> List[str]:
    """Python files changed vs ``base`` (plus any uncommitted edits).

    Rename-aware: ``git diff --name-status -M`` reports ``R<score>`` rows
    with both paths — a pure rename (``R100``) is content-identical to a
    file the base already linted, so it is skipped entirely; a rename with
    edits lints the *new* path.  Deletions never lint.
    """
    out: set = set()
    for args in (["git", "diff", "--name-status", "-M", f"{base}...HEAD"],
                 ["git", "diff", "--name-status", "-M", "HEAD"]):
        try:
            proc = subprocess.run(args, cwd=root, capture_output=True,
                                  text=True, check=False)
        except OSError:
            continue
        if proc.returncode != 0:
            continue
        out.update(_parse_name_status(proc.stdout))
    try:
        proc = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, check=False)
        if proc.returncode == 0:
            out.update(line.strip() for line in proc.stdout.splitlines()
                       if line.strip().endswith(".py"))
    except OSError:
        pass
    return sorted(out)


def _parse_name_status(text: str) -> List[str]:
    """``--name-status -M`` rows -> paths to lint (see changed_files)."""
    paths: List[str] = []
    for line in text.splitlines():
        parts = line.rstrip("\n").split("\t")
        if not parts or not parts[0]:
            continue
        status = parts[0]
        if status.startswith("D"):
            continue
        if status.startswith(("R", "C")):
            if len(parts) < 3:
                continue
            if status in ("R100", "C100"):
                continue                 # content-identical to the base
            path = parts[2]              # the new path carries the edits
        else:
            path = parts[-1]
        if path.endswith(".py"):
            paths.append(path)
    return paths
