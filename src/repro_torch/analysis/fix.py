"""``--fix`` — mechanical application of UN001 unit-suffix renames.

The twin of ``src/repro/analysis/fix.py``, unchanged in meaning.

The fix engine applies exactly the rename the UN001 finding message
suggests, but *everywhere at once* via the project index:

* the field definition (``AnnAssign`` target) on the unit struct,
* ``self.<field>`` reads inside the struct's own body,
* keyword arguments at every indexed constructor call site
  (``EnergyReport(energy=...)`` → ``EnergyReport(energy_j=...)``),
* attribute reads through locally-inferred instances
  (``r = EnergyReport(...); r.energy`` in the same function),
* dict-literal string keys flagged inside struct methods.

The suffix is picked from the name (``energy`` → ``_j``, ``power`` →
``_w``, ``temp`` → ``_c``, ``freq`` → ``_ghz``, else ``_us`` — the
default the finding message itself suggests).  Renames that would collide
with an existing name, and findings silenced by a waiver, are skipped with
a note.  Edits are token-precise (line/col spans from the AST) and applied
bottom-up so earlier spans stay valid; a second run finds no UN001
violations, so ``--fix`` is idempotent by construction.  The engine only
renames — it never reorders, reformats, or otherwise rewrites code, so
runtime behavior is unchanged (every reference moves with its definition).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .config import AnalysisConfig
from .findings import scan_waivers
from .project import ModuleInfo, ProjectIndex, dotted_name
from .rules_units import UnitViolation, unit_violations

#: name-substring -> unit suffix; first hit wins, fallback ``_us`` (the
#: suggestion UN001's own message makes)
SUFFIX_HINTS: Tuple[Tuple[str, str], ...] = (
    ("energy", "_j"),
    ("power", "_w"),
    ("temp", "_c"),
    ("freq", "_ghz"),
    ("volt", "_v"),
)
DEFAULT_SUFFIX = "_us"


def suggest_name(name: str) -> str:
    low = name.lower()
    for hint, sfx in SUFFIX_HINTS:
        if hint in low:
            return name + sfx
    return name + DEFAULT_SUFFIX


@dataclasses.dataclass(frozen=True)
class Edit:
    """Replace ``length`` chars at ``(line, col)`` of ``path`` with
    ``replacement``."""
    path: str
    line: int                   # 1-based
    col: int                    # 0-based
    length: int
    replacement: str


@dataclasses.dataclass
class FixResult:
    edits: List[Edit]
    skipped: List[str]          # human-readable skip notes
    files: Set[str]             # files rewritten

    @property
    def applied(self) -> int:
        return len(self.edits)


def plan_fixes(index: ProjectIndex, cfg: AnalysisConfig) -> FixResult:
    """Compute the rename edit set for every unwaived UN001 violation."""
    edits: List[Edit] = []
    skipped: List[str] = []
    waivers = {mod.path: scan_waivers(mod.source, mod.tree)
               for mod in index.modules.values()}

    for v in unit_violations(index, cfg):
        w = waivers.get(v.mod.path, {}).get(v.node.lineno)
        if w is not None and "UN001" in w.codes:
            skipped.append(f"{v.mod.path}:{v.node.lineno}: `{v.name}` "
                           f"is waived — left as-is")
            continue
        new = suggest_name(v.name)
        if v.kind == "field":
            if _collides(v.cls, new):
                skipped.append(f"{v.mod.path}:{v.node.lineno}: renaming "
                               f"`{v.name}` -> `{new}` collides with an "
                               f"existing member — fix manually")
                continue
            edits.extend(_field_edits(index, v, new))
        else:
            edits.extend(_dict_key_edits(v, new))

    # drop duplicate spans (two violations can reference one site)
    seen: Set[Tuple[str, int, int]] = set()
    unique: List[Edit] = []
    for e in edits:
        key = (e.path, e.line, e.col)
        if key not in seen:
            seen.add(key)
            unique.append(e)
    return FixResult(edits=unique, skipped=skipped, files=set())


def apply_fixes(root: Path, result: FixResult) -> FixResult:
    """Write the planned edits to disk, bottom-up per file."""
    by_path: Dict[str, List[Edit]] = {}
    for e in result.edits:
        by_path.setdefault(e.path, []).append(e)
    for path, file_edits in by_path.items():
        fp = Path(root) / path
        lines = fp.read_text().splitlines(keepends=True)
        for e in sorted(file_edits, key=lambda e: (e.line, e.col),
                        reverse=True):
            text = lines[e.line - 1]
            lines[e.line - 1] = (text[:e.col] + e.replacement +
                                 text[e.col + e.length:])
        fp.write_text("".join(lines))
        result.files.add(path)
    return result


# -- edit derivation ---------------------------------------------------------

def _collides(cls: ast.ClassDef, new: str) -> bool:
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and stmt.target.id == new:
            return True
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == new:
                    return True
    return False


def _field_edits(index: ProjectIndex, v: UnitViolation,
                 new: str) -> List[Edit]:
    old = v.name
    edits: List[Edit] = []
    assert isinstance(v.node, ast.AnnAssign)
    target = v.node.target
    edits.append(Edit(path=v.mod.path, line=target.lineno,
                      col=target.col_offset, length=len(old),
                      replacement=new))

    # self.<old> anywhere in the struct body (methods, defaults)
    for node in ast.walk(v.cls):
        if isinstance(node, ast.Attribute) and node.attr == old and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            edits.append(_attr_edit(v.mod, node, old, new))

    cls_dotted = f"{v.mod.module}.{v.cls.name}" if v.mod.module \
        else v.cls.name
    for mod in index.modules.values():
        edits.extend(_call_site_edits(mod, cls_dotted, old, new))
    return [e for e in edits if e is not None]


def _attr_edit(mod: ModuleInfo, node: ast.Attribute, old: str,
               new: str) -> Optional[Edit]:
    """Edit for the ``.attr`` part of an Attribute node (after the dot)."""
    line = node.value.end_lineno
    src_line = mod.source.splitlines()[line - 1] if line is not None else ""
    start = node.value.end_col_offset
    idx = src_line.find(old, start if start is not None else 0)
    if idx < 0:                     # attr on a continuation line: find it
        for ln in range(node.value.end_lineno, node.end_lineno + 1):
            text = mod.source.splitlines()[ln - 1]
            idx = text.find(old)
            if idx >= 0 and text[:idx].rstrip().endswith("."):
                return Edit(path=mod.path, line=ln, col=idx,
                            length=len(old), replacement=new)
        return None
    return Edit(path=mod.path, line=line, col=idx, length=len(old),
                replacement=new)


def _call_site_edits(mod: ModuleInfo, cls_dotted: str, old: str,
                     new: str) -> List[Edit]:
    edits: List[Edit] = []
    # constructor keyword args
    ctor_vars: Dict[Tuple[ast.AST, str], bool] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and \
                dotted_name(node.func, mod) == cls_dotted:
            for kw in node.keywords:
                if kw.arg == old:
                    edits.append(Edit(path=mod.path, line=kw.lineno,
                                      col=kw.col_offset, length=len(old),
                                      replacement=new))
        # record vars assigned from the constructor for attribute renames
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                dotted_name(node.value.func, mod) == cls_dotted:
            fn = mod.enclosing_function(node) or mod.tree
            ctor_vars[(fn, node.targets[0].id)] = True
    # <var>.<old> where <var> is locally inferred as an instance
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and node.attr == old and \
                isinstance(node.value, ast.Name):
            fn = mod.enclosing_function(node) or mod.tree
            if ctor_vars.get((fn, node.value.id)):
                e = _attr_edit(mod, node, old, new)
                if e is not None:
                    edits.append(e)
    return edits


def _dict_key_edits(v: UnitViolation, new: str) -> List[Edit]:
    node = v.node
    if isinstance(node, ast.Constant):       # {"energy": ...}
        raw = v.mod.source.splitlines()[node.lineno - 1]
        quote = raw[node.col_offset] if node.col_offset < len(raw) else '"'
        if quote not in "\"'":
            quote = '"'
        literal_len = (node.end_col_offset - node.col_offset
                       if node.end_lineno == node.lineno else len(v.name) + 2)
        return [Edit(path=v.mod.path, line=node.lineno,
                     col=node.col_offset, length=literal_len,
                     replacement=f"{quote}{new}{quote}")]
    if isinstance(node, ast.keyword):        # dict(energy=...)
        return [Edit(path=v.mod.path, line=node.lineno,
                     col=node.col_offset, length=len(v.name),
                     replacement=new)]
    return []
