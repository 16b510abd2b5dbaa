"""Findings + inline waivers for the ``repro_torch.analysis`` lint suite.

The twin of ``src/repro/analysis/findings.py``, the same in meaning: the
waiver form is shared, so one comment can serve both linters.

A :class:`Finding` is one rule violation pinned to a file/line.  Waivers are
inline comments that acknowledge a finding instead of fixing it::

    os.environ["X"] = "1"   # lint: waive TX003 -- deliberate, see ROADMAP

    # lint: waive UN001 -- ratio, dimensionless by construction
    offending_line = ...

The first form waives codes on its own line; a standalone waiver comment
waives the *next* line.  The justification after ``--`` is required in
``--strict`` runs: a bare waiver raises ``WV001`` so silent suppressions
cannot accumulate.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence

REPORT_SCHEMA = "repro_torch.analysis/report/v1"

#: ``# lint: waive TX001[,TX002] [-- justification]``
WAIVER_RE = re.compile(
    r"#\s*lint:\s*waive\s+"
    r"(?P<codes>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"\s*(?:--\s*(?P<reason>\S.*?))?\s*$")

#: severity -> the word rendered in reports (and matched by the CI problem
#: matcher / mapped to SARIF result levels)
SEVERITY_WORD = {"error": "error", "warn": "warning", "info": "note"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or acknowledged waiver) at ``path:line``."""
    code: str                       # e.g. "TX001"
    path: str                       # repo-relative file path
    line: int                       # 1-based
    message: str
    col: int = 0
    severity: str = "error"         # error | warn | info
    waived: bool = False
    waiver_reason: Optional[str] = None

    def render(self) -> str:
        tag = " (waived)" if self.waived else ""
        word = SEVERITY_WORD.get(self.severity, self.severity)
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{word}{tag}: {self.message}"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Waiver:
    codes: frozenset
    reason: Optional[str]
    line: int                       # the waiver comment's own line


def scan_waivers(source: str,
                 tree: Optional[ast.Module] = None) -> Dict[int, Waiver]:
    """Map *waived line number* -> :class:`Waiver` for one file.

    A waiver comment trailing code applies to its own line; a comment-only
    waiver line applies to itself and the following line (so long statements
    can carry the waiver above them).  When the parsed ``tree`` is supplied
    two further forms resolve:

    * a trailing waiver on a **continuation line** of a multi-line statement
      also covers the statement's reporting line (its ``lineno``), so a
      finding pinned to the statement start is still waivable in place;
    * a standalone waiver above a **decorated def/class** also covers the
      ``def``/``class`` line itself (the comment's "next line" is the first
      decorator, but findings pin to the definition line).
    """
    out: Dict[int, Waiver] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = WAIVER_RE.search(text)
        if not m:
            continue
        codes = frozenset(c.strip() for c in m.group("codes").split(","))
        w = Waiver(codes=codes, reason=m.group("reason"), line=i)
        out[i] = w
        if text.lstrip().startswith("#"):      # standalone comment line
            out.setdefault(i + 1, w)
            if tree is not None:
                target = _decorated_def_line(tree, i + 1)
                if target is not None:
                    out.setdefault(target, w)
        elif tree is not None:
            start = _statement_start(tree, i)
            if start is not None and start != i:
                out.setdefault(start, w)
    return out


def _decorated_def_line(tree: ast.Module, line: int) -> Optional[int]:
    """The ``def``/``class`` line when ``line`` is its first decorator."""
    for node in ast.walk(tree):
        decs = getattr(node, "decorator_list", None)
        if decs and decs[0].lineno == line:
            return node.lineno
    return None


def _statement_start(tree: ast.Module, line: int) -> Optional[int]:
    """Reporting line of the innermost statement spanning ``line``."""
    best: Optional[int] = None
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        end = getattr(node, "end_lineno", None)
        if end is None or not (node.lineno <= line <= end):
            continue
        if best is None or node.lineno > best:
            best = node.lineno
    return best


def apply_waivers(findings: Sequence[Finding],
                  waivers_by_path: Dict[str, Dict[int, Waiver]],
                  strict: bool = False) -> List[Finding]:
    """Mark findings covered by a waiver; in strict mode add ``WV001`` for
    waivers that carry no ``--`` justification."""
    out: List[Finding] = []
    used: set = set()
    for f in findings:
        w = waivers_by_path.get(f.path, {}).get(f.line)
        if w is not None and f.code in w.codes:
            used.add((f.path, w.line))
            out.append(dataclasses.replace(f, waived=True,
                                           waiver_reason=w.reason))
        else:
            out.append(f)
    if strict:
        for path, waivers in waivers_by_path.items():
            for w in set(waivers.values()):
                if w.reason is None:
                    out.append(Finding(
                        code="WV001", path=path, line=w.line,
                        message="waiver without justification; append "
                                "'-- <why this is safe>'"))
    return out


def active(findings: Sequence[Finding]) -> List[Finding]:
    """Findings not silenced by a waiver (any severity)."""
    return [f for f in findings if not f.waived]


def gating(findings: Sequence[Finding], strict: bool = False) \
        -> List[Finding]:
    """Active findings that fail the run: ``error`` always, ``warn`` only
    under ``--strict`` (the CI mode), ``info`` never."""
    levels = ("error", "warn") if strict else ("error",)
    return [f for f in active(findings) if f.severity in levels]


def render_report(findings: Sequence[Finding]) -> str:
    lines = [f.render() for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.code))]
    act = active(findings)
    waived = len(findings) - len(act)
    per_sev = {lvl: sum(1 for f in act if f.severity == lvl)
               for lvl in ("error", "warn", "info")}
    lines.append(f"{len(act)} finding(s) "
                 f"({per_sev['error']} error, {per_sev['warn']} warn, "
                 f"{per_sev['info']} info), {waived} waived")
    return "\n".join(lines)


def report_payload(findings: Sequence[Finding], **extra) -> Dict:
    """JSON-ready findings report (the CI artifact next to BENCH_*.json)."""
    per_code: Dict[str, int] = {}
    for f in active(findings):
        per_code[f.code] = per_code.get(f.code, 0) + 1
    per_sev: Dict[str, int] = {}
    for f in active(findings):
        per_sev[f.severity] = per_sev.get(f.severity, 0) + 1
    payload = {
        "schema": REPORT_SCHEMA,
        "findings": [f.to_dict() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.code))],
        "summary": {"active": len(active(findings)),
                    "waived": len(findings) - len(active(findings)),
                    "per_code": dict(sorted(per_code.items())),
                    "per_severity": dict(sorted(per_sev.items()))},
    }
    payload.update(extra)
    return payload


def dump_report(findings: Sequence[Finding], path: str, **extra) -> None:
    with open(path, "w") as fh:
        json.dump(report_payload(findings, **extra), fh, indent=2)
