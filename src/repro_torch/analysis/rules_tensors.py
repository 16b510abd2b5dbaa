"""TD001 — tensor-carrying dataclasses, the twin of PT001.

The reference registers its table and policy dataclasses as pytrees and
PT001 holds them frozen (a jit cache key must hash).  The port's twins carry
``torch.Tensor`` fields, and a dataclass's generated ``__eq__`` compares its
fields as a tuple: on two tensors of more than one element that raises
"Boolean value of Tensor with more than one element is ambiguous", and on a
one-element CUDA tensor it syncs.  So a dataclass with a field annotated
``torch.Tensor`` (or ``Optional[torch.Tensor]``, ...):

* is ``frozen=True`` — shared tables are not re-pointed under a running
  launch, and a frozen instance can key a cache by identity;
* is ``eq=False`` (identity equality and hash, as ``SimTables`` in
  ``core/simkernel_torch.py``), or every tensor field is
  ``dataclasses.field(compare=False)``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .findings import Finding
from .project import ModuleInfo, ProjectIndex, dotted_name


def _dataclass_flags(cls: ast.ClassDef, mod: ModuleInfo) \
        -> Optional[Dict[str, bool]]:
    """None: not a dataclass; else its ``frozen`` and ``eq`` flags."""
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(target, mod) != "dataclasses.dataclass":
            continue
        flags = {"frozen": False, "eq": True}
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg in flags and isinstance(kw.value, ast.Constant):
                    flags[kw.arg] = bool(kw.value.value)
        return flags
    return None


def _tensor_fields(cls: ast.ClassDef) -> List[Tuple[str, ast.AnnAssign]]:
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                "Tensor" in ast.unparse(stmt.annotation) and \
                "ClassVar" not in ast.unparse(stmt.annotation):
            out.append((stmt.target.id, stmt))
    return out


def _compare_false(stmt: ast.AnnAssign, mod: ModuleInfo) -> bool:
    v = stmt.value
    if not (isinstance(v, ast.Call) and
            dotted_name(v.func, mod) == "dataclasses.field"):
        return False
    return any(kw.arg == "compare" and isinstance(kw.value, ast.Constant)
               and kw.value.value is False for kw in v.keywords)


def check_tensor_rules(index: ProjectIndex,
                       sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        for cls in mod.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            fields = _tensor_fields(cls)
            flags = _dataclass_flags(cls, mod)
            if not fields or flags is None:
                continue
            sites.setdefault("TD001", []).append(f"{mod.path}:{cls.lineno}")

            def emit(msg: str) -> None:
                out.append(Finding(code="TD001", path=mod.path,
                                   line=cls.lineno, col=cls.col_offset,
                                   message=msg))

            names = [n for n, _ in fields]
            if not flags["frozen"]:
                emit(f"dataclass `{cls.name}` carries tensors {names} and "
                     f"must be frozen=True")
            if flags["eq"]:
                compared = [n for n, st in fields
                            if not _compare_false(st, mod)]
                if compared:
                    emit(f"dataclass `{cls.name}` compares tensor fields "
                         f"{compared} in its generated __eq__ (ambiguous "
                         f"truth value, or a sync): declare eq=False or "
                         f"field(compare=False)")
    out.sort(key=lambda f: (f.path, f.line, f.message))
    return out
