"""SARIF 2.1.0 emitter — findings as GitHub code-scanning annotations.

The twin of ``src/repro/analysis/sarif.py``; ``tool.driver.name`` names this
linter.  ``python -m repro_torch.analysis --sarif findings.sarif`` (or
``--format sarif`` on stdout) serialises the findings report as a SARIF
2.1.0 log so CI's ``analysis`` job can hand it to
``github/codeql-action/upload-sarif`` and lint findings annotate the PR
diff instead of hiding in an artifact.

Mapping:

* severity ``error``/``warn``/``info`` -> SARIF result ``level``
  ``error``/``warning``/``note`` (the same words the text renderer and
  problem matcher use);
* waived findings are emitted with a ``suppressions`` entry of kind
  ``inSource`` (GitHub hides suppressed results but keeps the audit
  trail) carrying the waiver justification;
* every known rule appears in ``tool.driver.rules`` with its one-line doc,
  so annotations link to rule metadata.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

from .config import DEFAULT_SEVERITY, RULE_DOCS
from .findings import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")
_TOOL_NAME = "repro_torch.analysis"

#: severity -> SARIF result level (note SARIF says "warning", we say "warn")
_LEVEL = {"error": "error", "warn": "warning", "info": "note"}


def sarif_payload(findings: Sequence[Finding],
                  tool_version: str = "2.0") -> Dict:
    rules = [{
        "id": code,
        "name": code,
        "shortDescription": {"text": doc},
        "defaultConfiguration": {
            "level": _LEVEL.get(DEFAULT_SEVERITY.get(code, "error"),
                                "error")},
    } for code, doc in sorted(RULE_DOCS.items())]
    rule_index = {r["id"]: i for i, r in enumerate(rules)}

    results: List[Dict] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        result: Dict = {
            "ruleId": f.code,
            "level": _LEVEL.get(f.severity, "error"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": f.line,
                               "startColumn": f.col + 1},
                },
            }],
        }
        if f.code in rule_index:
            result["ruleIndex"] = rule_index[f.code]
        if f.waived:
            sup: Dict = {"kind": "inSource"}
            if f.waiver_reason:
                sup["justification"] = f.waiver_reason
            result["suppressions"] = [sup]
        results.append(result)

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": _TOOL_NAME,
                "informationUri":
                    "https://arxiv.org/abs/2003.09016",
                "version": tool_version,
                "rules": rules,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }


def render_sarif(findings: Sequence[Finding]) -> str:
    return json.dumps(sarif_payload(findings), indent=2)


def dump_sarif(findings: Sequence[Finding], path: str) -> None:
    with open(path, "w") as fh:
        fh.write(render_sarif(findings) + "\n")
