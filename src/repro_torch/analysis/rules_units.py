"""UN001 — unit-suffix discipline on result/report structs.

The twin of ``src/repro/analysis/rules_units.py``, unchanged in meaning (a
``torch.Tensor`` field is numeric as an ``ndarray`` one is).

The paper's tables mix microseconds, Joules, Watts, Celsius and GHz; a bare
``latency`` field is how µs gets averaged into ms.  Every *numeric* field of
the configured structs (``unit-structs``, ``config.DEFAULT_UNIT_STRUCTS``),
and every string key of dict literals built inside their methods (``to_dict``
payloads feed the run manifests), must either end in an accepted unit
suffix (``_us``, ``_j``, …) or match a dimensionless allow pattern
(``util*``, ``*_idx``, ``num_*``, …).  Integer-annotated fields are exempt —
counts and indices carry no unit.

:func:`unit_violations` exposes the raw violations (struct, node, kind) so
the ``--fix`` engine (:mod:`repro_torch.analysis.fix`) can mechanically apply
the rename the finding message suggests; :func:`check_unit_rules` renders the
same violations as findings.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import re
from typing import Iterator, List, Optional

from .config import AnalysisConfig
from .findings import Finding
from .project import ModuleInfo, ProjectIndex

_NUMERIC_ANN = re.compile(r"\bfloat\b|ndarray|\bArray\b|jnp\.|\bcomplex\b"
                          r"|\bTensor\b")


def _looks_numeric(ann: str) -> bool:
    return bool(_NUMERIC_ANN.search(ann))


def _is_dataclass_like(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        src = ast.unparse(target)
        if src.endswith("dataclass") or src.endswith("NamedTuple"):
            return True
    return any(isinstance(b, ast.Name) and b.id == "NamedTuple"
               for b in cls.bases)


def _name_ok(name: str, cfg: AnalysisConfig) -> bool:
    if any(name.endswith(sfx) for sfx in cfg.unit_suffixes):
        return True
    return any(fnmatch.fnmatchcase(name, pat) for pat in cfg.unit_allow)


@dataclasses.dataclass(frozen=True)
class UnitViolation:
    """One suffix-less name on a unit struct, addressable for ``--fix``."""
    mod: ModuleInfo
    cls: ast.ClassDef
    kind: str                   # "field" | "dict_key"
    node: ast.AST               # AnnAssign (field) / Constant / keyword
    name: str
    method: Optional[str] = None   # enclosing method for dict keys


def unit_violations(index: ProjectIndex,
                    cfg: AnalysisConfig) -> Iterator[UnitViolation]:
    for mod in index.modules.values():
        for cls in mod.classes.values():
            if cls.name not in cfg.unit_structs:
                continue
            if not _is_dataclass_like(cls):
                continue
            for stmt in cls.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    ann = ast.unparse(stmt.annotation)
                    if _looks_numeric(ann) and \
                            not _name_ok(stmt.target.id, cfg):
                        yield UnitViolation(mod=mod, cls=cls, kind="field",
                                            node=stmt, name=stmt.target.id)
                elif isinstance(stmt, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    for key_node, key in _dict_keys(stmt):
                        if not _name_ok(key, cfg):
                            yield UnitViolation(mod=mod, cls=cls,
                                                kind="dict_key",
                                                node=key_node, name=key,
                                                method=stmt.name)


def check_unit_rules(index: ProjectIndex,
                     cfg: AnalysisConfig) -> List[Finding]:
    out: List[Finding] = []
    suffixes = ", ".join(cfg.unit_suffixes)
    for v in unit_violations(index, cfg):
        what = "numeric field" if v.kind == "field" else \
            f"dict key (in `{v.method}()`)"
        out.append(Finding(
            code="UN001", path=v.mod.path, line=v.node.lineno,
            col=v.node.col_offset,
            message=f"{what} `{v.name}` on `{v.cls.name}` lacks a unit "
                    f"suffix ({suffixes}); rename (e.g. "
                    f"`{v.name}_us`) or add an `unit-allow` pattern"))
    return out


def _dict_keys(fn: ast.AST):
    """String keys of dict literals / dict(...) calls in a method body."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k, k.value
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and node.func.id == "dict":
            for kw in node.keywords:
                if kw.arg is not None:
                    yield kw, kw.arg
