"""SC001 — loop-step carry stability, the twin of the reference's scan-carry.

The reference's ``lax.scan`` / ``while_loop`` bodies become Python loops in
the port: a ``for``/``while`` body that re-binds its carry through a step
function, ``a, b = step(a, b, x)``.  Nothing traces the carry any more, so a
step that changes its shape or dtype runs on silently.  The bug classes the
reference's SC001 checks are checked here on those sites:

* **arity** — the step returns a tuple of another length than the names the
  loop re-binds;
* **element order** — the step returns exactly its carried parameters in
  another order than the loop re-binds them: the shapes may agree, the
  values are swapped;
* **dtype** — a carried name initialised as an integer (an ``int`` literal,
  ``torch.zeros(..., dtype=torch.int32)``, ``torch.arange(n)``, ...) comes
  back through ``/`` (true division) or a mean: torch promotes it to float
  and the bit-for-bit contract with the integer scan breaks; or it comes
  back cast (``.to(torch.float32)``, ``.float()``, ``.long()``, ...) to
  another kind than its init, or cast on one ``return`` path only.

The machinery (init kinds, true division, casts across return paths) is
``src/repro/analysis/rules_scan.py``'s, re-aimed from ``lax`` calls to loop
sites.  Everything is best-effort pure AST: a step that is not a resolvable
function, or returns an opaque value, is skipped, never guessed at.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from .findings import Finding
from .project import ModuleInfo, ProjectIndex, dotted_name

_MEAN_CALLS = ("torch.mean", "torch.nanmean", "numpy.mean",
               "numpy.average")
_FLOAT_METHODS = {"float", "double", "half", "bfloat16"}
_INT_METHODS = {"long", "int", "short", "char", "byte", "bool"}
_FACTORIES = ("zeros", "ones", "full", "tensor", "as_tensor", "asarray",
              "array", "empty", "zeros_like", "ones_like", "full_like",
              "empty_like")


def check_loop_rules(index: ProjectIndex,
                     sites: Dict[str, List[str]]) -> List[Finding]:
    raw: List[Finding] = []
    for mod in index.modules.values():
        for loop in mod.nodes:
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for st in _own_statements(loop):
                site = _step_site(st, mod, index)
                if site is None:
                    continue
                sites.setdefault("SC001", []).append(
                    f"{mod.path}:{st.lineno}")
                raw.extend(_check_site(loop, st, mod, *site))
    seen, out = set(), []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.message)):
        key = (f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _own_statements(loop: ast.AST) -> Iterator[ast.AST]:
    """Assignments in a loop's body, not in nested loops or defs (a nested
    loop is a site of its own)."""
    stack = list(loop.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Assign):
            yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda, ast.For, ast.AsyncFor,
                             ast.While)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _step_site(st: ast.Assign, mod: ModuleInfo, index: ProjectIndex) \
        -> Optional[Tuple[List[str], ast.Call, ModuleInfo, ast.AST,
                          Dict[str, str]]]:
    """``(re-bound names, call, callee module, callee def, name -> the
    callee's parameter it feeds)`` of ``a, b = step(a, b, ...)``."""
    if len(st.targets) != 1 or not isinstance(st.value, ast.Call):
        return None
    t = st.targets[0]
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple) and all(isinstance(e, ast.Name)
                                          for e in t.elts):
        names = [e.id for e in t.elts]
    else:
        return None
    call = st.value
    fn = mod.resolve_local(call.func, call)
    fn_mod = mod
    if fn is None:
        d = dotted_name(call.func, mod)
        hit = index.resolve_function(d) if d else None
        if hit is None:
            return None
        fn_mod, fn = hit
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    params = [p.arg for p in fn.args.posonlyargs + fn.args.args]
    if params[:1] in (["self"], ["cls"]) and \
            isinstance(call.func, ast.Attribute):
        params = params[1:]
    feeds: Dict[str, str] = {}
    for i, a in enumerate(call.args):
        if isinstance(a, ast.Name) and a.id in names and i < len(params):
            feeds.setdefault(a.id, params[i])
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name) and kw.value.id in names \
                and kw.arg is not None:
            feeds.setdefault(kw.value.id, kw.arg)
    if not feeds:
        return None
    return names, call, fn_mod, fn, feeds


def _walk_own(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# -- dtype classification ----------------------------------------------------

def _dtype_kind_of_name(dotted: Optional[str]) -> Optional[str]:
    """``torch.int32`` -> "int", ``numpy.float32`` -> "float", …"""
    if not dotted:
        return None
    leaf = dotted.rsplit(".", 1)[-1]
    if leaf.startswith(("int", "uint", "long", "short")) or \
            leaf in ("bool", "bool_"):
        return "int"
    if leaf.startswith(("float", "bfloat", "half", "double")):
        return "float"
    return None


def _init_kind(expr: Optional[ast.AST], mod: ModuleInfo) -> Optional[str]:
    """Best-effort dtype kind ("int"/"float") of an initial value."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, bool):
            return None
        if isinstance(expr.value, int):
            return "int"
        if isinstance(expr.value, float):
            return "float"
        return None
    if isinstance(expr, ast.UnaryOp):
        return _init_kind(expr.operand, mod)
    if not isinstance(expr, ast.Call):
        return None
    cast = _cast_target(expr, mod)
    if cast:
        return cast
    dotted = dotted_name(expr.func, mod) or ""
    kind = _dtype_kind_of_name(dotted)
    if kind is not None:                     # np.int32(0)
        return kind
    leaf = dotted.rsplit(".", 1)[-1]
    if dotted.startswith(("torch.", "numpy.")) and leaf in _FACTORIES:
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _dtype_kind_of_name(dotted_name(kw.value, mod))
        if leaf in ("tensor", "as_tensor", "asarray", "array") and expr.args:
            return _init_kind(expr.args[0], mod)
        if leaf == "full" and len(expr.args) >= 2:
            return _init_kind(expr.args[1], mod)
        return "float" if leaf in ("zeros", "ones", "empty") else None
    if dotted in ("torch.arange", "numpy.arange"):
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _dtype_kind_of_name(dotted_name(kw.value, mod))
        kinds = {_init_kind(a, mod) for a in expr.args}
        return None if "float" in kinds else "int"
    return None


def _names_in(expr: ast.AST) -> set:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _has_true_div(expr: ast.AST, names: set) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div):
            if not names or (_names_in(n) & names):
                return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("div", "true_divide") and not any(
                    kw.arg == "rounding_mode" for kw in n.keywords):
            if not names or (_names_in(n) & names):
                return True
    return False


def _mean_call(expr: ast.AST, mod: ModuleInfo) -> Optional[str]:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func, mod)
            if d in _MEAN_CALLS:
                return d
            if isinstance(n.func, ast.Attribute) and n.func.attr == "mean":
                return ".mean()"
    return None


def _cast_target(expr: ast.AST, mod: ModuleInfo) -> Optional[str]:
    """Dtype kind of a top-level cast (``x.to(T)``, ``x.float()``,
    ``x.type(T)``, ``x.astype(T)``), "" when unknown, None if no cast."""
    if not (isinstance(expr, ast.Call) and
            isinstance(expr.func, ast.Attribute)):
        return None
    attr = expr.func.attr
    if attr in _FLOAT_METHODS and not expr.args:
        return "float"
    if attr in _INT_METHODS and not expr.args:
        return "int"
    if attr in ("to", "type", "astype"):
        cands = list(expr.args) + [kw.value for kw in expr.keywords
                                   if kw.arg == "dtype"]
        for c in cands:
            kind = _dtype_kind_of_name(dotted_name(c, mod))
            if kind:
                return kind
        return "" if attr != "to" else None
    return None


# -- the per-site check ------------------------------------------------------

def _init_of(name: str, loop: ast.AST, mod: ModuleInfo) -> Optional[ast.AST]:
    """The value last bound to ``name`` before ``loop`` in its scope."""
    scope = mod.enclosing_function(loop) or mod.tree
    best = None
    for n in _walk_own(scope) if scope is not mod.tree else ast.walk(scope):
        if isinstance(n, ast.Assign) and n.lineno < loop.lineno and \
                len(n.targets) == 1:
            t = n.targets[0]
            if isinstance(t, ast.Name) and t.id == name:
                cand = n.value
            elif isinstance(t, ast.Tuple) and isinstance(n.value, ast.Tuple) \
                    and len(t.elts) == len(n.value.elts):
                cand = next((v for e, v in zip(t.elts, n.value.elts)
                             if isinstance(e, ast.Name) and e.id == name),
                            None)
            else:
                cand = None
            if cand is not None and (best is None or n.lineno > best[0]):
                best = (n.lineno, cand)
    return best[1] if best else None


def _check_site(loop: ast.AST, st: ast.Assign, mod: ModuleInfo,
                names: List[str], call: ast.Call, fn_mod: ModuleInfo,
                fn: ast.AST, feeds: Dict[str, str]) -> List[Finding]:
    out: List[Finding] = []
    display = fn.name

    def emit(line: int, col: int, msg: str) -> None:
        out.append(Finding(code="SC001", path=fn_mod.path, line=line,
                           col=col, message=msg))

    returns = [(n.lineno, n.value) for n in _walk_own(fn)
               if isinstance(n, ast.Return) and n.value is not None]
    tuple_target = isinstance(st.targets[0], ast.Tuple)
    expected = [feeds.get(n) for n in names]
    casts_by_pos: Dict[int, set] = {}
    n_tuple_returns = 0
    for line, value in returns:
        if tuple_target and isinstance(value, ast.Tuple):
            n_tuple_returns += 1
            elts = value.elts
            if len(elts) != len(names):
                emit(line, value.col_offset,
                     f"loop step `{display}` returns {len(elts)} "
                     f"element(s), the loop on line {st.lineno} re-binds "
                     f"{len(names)} ({', '.join(names)}) — the carry arity "
                     f"diverges")
                continue
            if None not in expected and \
                    all(isinstance(e, ast.Name) for e in elts):
                ret = [e.id for e in elts]
                if ret != expected and sorted(ret) == sorted(expected):
                    emit(line, value.col_offset,
                         f"loop step `{display}` returns its carry "
                         f"reordered ({', '.join(ret)}) vs the loop's "
                         f"re-bind on line {st.lineno} "
                         f"({', '.join(expected)})")
            pairs = list(enumerate(elts))
        elif not tuple_target:
            pairs = [(0, value)]
        else:
            continue                         # opaque return: never guessed
        for i, e in pairs:
            if _cast_target(e, fn_mod) is not None:
                casts_by_pos.setdefault(i, set()).add(line)
            param = expected[i]
            init = _init_of(names[i], loop, mod)
            _check_elt_dtype(display, names[i], param, init, e, line,
                             fn_mod, mod, emit)
    if n_tuple_returns > 1:
        for i, at_lines in sorted(casts_by_pos.items()):
            if len(at_lines) < n_tuple_returns:
                emit(max(at_lines), 0,
                     f"loop step `{display}` casts carry element {i} "
                     f"(`{names[i]}`) on {len(at_lines)} of "
                     f"{n_tuple_returns} return paths — the carry dtype "
                     f"diverges between branches")
    return out


def _check_elt_dtype(display: str, name: str, param: Optional[str],
                     init: Optional[ast.AST], ret_e: ast.AST, line: int,
                     fn_mod: ModuleInfo, call_mod: ModuleInfo, emit) -> None:
    init_kind = _init_kind(init, call_mod)
    if init_kind == "int" and param is not None:
        names = {param}
        if _has_true_div(ret_e, names):
            emit(line, ret_e.col_offset,
                 f"loop step `{display}`: true division promotes the "
                 f"int-initialised carry `{name}` to float — the carry "
                 f"dtype diverges from its init (use `//` or a float init)")
            return
        mean = _mean_call(ret_e, fn_mod)
        if mean is not None and _names_in(ret_e) & names:
            emit(line, ret_e.col_offset,
                 f"loop step `{display}`: `{mean}` promotes the "
                 f"int-initialised carry `{name}` to float — the carry "
                 f"dtype diverges from its init")
            return
    cast = _cast_target(ret_e, fn_mod)
    if cast and init_kind is not None and cast != init_kind:
        emit(line, ret_e.col_offset,
             f"loop step `{display}`: carry `{name}` comes back cast to "
             f"<{cast}> but is initialised {init_kind} before the loop — "
             f"the carry dtype diverges from its init")
