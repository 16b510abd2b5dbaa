"""DN001 — in-place alias, the twin of the reference's use-after-donate.

Where the reference's ``jit`` donates a buffer, the port updates in place
(``optim/adamw.py``: ``master``, ``mu`` and ``nu``).  The hazard moves with
it: ``y = x.to(dtype)`` is ``x`` itself when ``x`` already has that dtype
(and device), and so are ``x.float()``, ``x.type(T)``, ``x.detach()`` and
``torch.as_tensor(x)``.  An in-place write to ``y`` then writes ``x``, in
exactly the configurations where the dtypes happen to match — the "donate
it twice" case that ``adamw_init`` avoids with ``.to(..., copy=True)``.

The rule flags an in-place write — a method ending in ``_`` (``add_``,
``mul_``, ``copy_``, ...), an ``out=`` argument, a subscript assignment
``y[...] = ...``, or an augmented assignment ``y += ...`` — to a name bound
in the same function to one of those aliasing conversions, without
``copy=True`` and without a ``.clone()`` after it: the first such write of
each binding.  A write through
``.view``, ``.reshape`` or indexing is left alone: those are views on
purpose (the KV cache's slot scatter in ``serving/engine.py`` writes through
one), and only a name that may or may not alias is a hazard.  A rebind of
the name ends its window, as a rebind ends the reference's.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .findings import Finding
from .project import ModuleInfo, ProjectIndex, dotted_name

#: methods whose result is the receiver itself when nothing needs converting
_ALIAS_METHODS = {"to", "float", "double", "half", "bfloat16", "long", "int",
                  "type", "detach", "contiguous", "type_as", "cuda", "cpu"}
#: in-place methods that change no data
_NOT_WRITES = {"requires_grad_", "share_memory_", "retain_grad_",
               "record_stream_"}


def _alias_source(expr: ast.AST, mod: ModuleInfo) -> Optional[str]:
    """The spelling of an aliasing conversion at the top of ``expr``."""
    if not isinstance(expr, ast.Call):
        return None
    if any(kw.arg == "copy" and not (isinstance(kw.value, ast.Constant)
                                     and kw.value.value is False)
           for kw in expr.keywords):
        return None
    f = expr.func
    if isinstance(f, ast.Attribute) and f.attr in _ALIAS_METHODS:
        return f".{f.attr}()"
    if dotted_name(f, mod) in ("torch.as_tensor", "torch.asarray"):
        return dotted_name(f, mod)
    return None


def _write_of(n: ast.AST) -> List[Tuple[str, str]]:
    """``(name, how)`` of the in-place writes to a bare name ``n`` makes."""
    out = []
    if isinstance(n, ast.Call):
        f = n.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.attr.endswith("_") and not f.attr.startswith("_") \
                and f.attr not in _NOT_WRITES:
            out.append((f.value.id, f".{f.attr}()"))
        for kw in n.keywords:
            if kw.arg == "out" and isinstance(kw.value, ast.Name):
                out.append((kw.value.id, "out="))
    elif isinstance(n, ast.Assign):
        for t in n.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                out.append((t.value.id, "a subscript assignment"))
    elif isinstance(n, ast.AugAssign):
        if isinstance(n.target, ast.Name):
            out.append((n.target.id, "an augmented assignment"))
        elif isinstance(n.target, ast.Subscript) and \
                isinstance(n.target.value, ast.Name):
            out.append((n.target.value.id, "a subscript assignment"))
    return out


def _bindings(fn: ast.AST) -> Dict[str, List[Tuple[int, ast.AST]]]:
    """name -> [(line, value)] of its plain bindings in ``fn``'s own body
    (a non-call binding, e.g. a loop target, carries ``None``)."""
    out: Dict[str, List[Tuple[int, ast.AST]]] = {}
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append((n.lineno, n.value))
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name):
                            out.setdefault(e.id, []).append((n.lineno, None))
        elif isinstance(n, (ast.For, ast.AsyncFor, ast.With, ast.comprehension,
                            ast.NamedExpr, ast.AnnAssign)):
            tgt = getattr(n, "target", None)
            value = getattr(n, "value", None) if isinstance(
                n, (ast.NamedExpr, ast.AnnAssign)) else None
            targets = [tgt] if tgt is not None else \
                [i.optional_vars for i in getattr(n, "items", [])
                 if i.optional_vars is not None]
            for t in targets:
                for e in ast.walk(t):
                    if isinstance(e, ast.Name):
                        out.setdefault(e.id, []).append(
                            (getattr(n, "lineno", 0), value))
    for v in out.values():
        v.sort(key=lambda lv: lv[0])
    return out


def check_inplace_rules(index: ProjectIndex,
                        sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        binds: Dict[ast.AST, Dict] = {}
        flagged = set()                  # one finding per aliasing binding
        found = [(node, w) for node in mod.nodes if (w := _write_of(node))]
        found.sort(key=lambda nw: (nw[0].lineno, nw[0].col_offset))
        for node, writes in found:
            fn = mod.enclosing_function(node)
            if fn is None or isinstance(fn, ast.Lambda):
                continue
            for name, how in writes:
                sites.setdefault("DN001", []).append(
                    f"{mod.path}:{node.lineno}")
                if fn not in binds:
                    binds[fn] = _bindings(fn)
                # the binding in force: the last one on an earlier line
                prior = [(line, v) for line, v in binds[fn].get(name, ())
                         if line < node.lineno]
                if not prior or prior[-1][1] is None:
                    continue
                line, value = prior[-1]
                src = _alias_source(value, mod)
                if src is None or (fn, name, line) in flagged:
                    continue
                flagged.add((fn, name, line))
                out.append(Finding(
                    code="DN001", path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"{how} writes `{name}` in place, and `{name}` "
                            f"is `{src}` of another tensor (line {line}): "
                            f"that is the source itself whenever nothing "
                            f"needed converting — pass copy=True or "
                            f".clone() it"))
    out.sort(key=lambda f: (f.path, f.line, f.col))
    return out
