"""The hot set — which code runs on a device hot path.

The twin of ``src/repro/analysis/reachability.py``'s jit-reachable set.
Torch eager has no decorator that marks traced code, so the roots are listed:
``hot-roots`` in the configuration (``config.DEFAULT_HOT_ROOTS``: the train,
prefill and serve step closures, ``Model.decode_step``, ``ServeEngine.step``,
the simulator's batched entry points, the grid sweep and the peak-temperature
grid), and every kernel wrapper that launches through a library from
``_build.load`` (found by :func:`kernel_wrappers`, not listed).

Edges follow plain calls (and ``functools.partial`` wrapping) to functions
across the indexed modules, through re-exports, to defs nested in an
enclosing scope, and ``self.m(...)`` to the enclosing class's ``m``.
Everything lexically inside a hot function (nested defs, lambdas) runs with
it and is scanned as one unit.

**The hot set never enters a kernel's plain version.**  By the port's own
rule only a CPU tensor reaches a ``*_plain`` function, and K1's
``epoch_scan_plain`` with its DTPM carry ``_Windows`` is the kernel's CPU
oracle, full of deliberate host loops; ``hot-exclude``
(``config.DEFAULT_HOT_EXCLUDE``) names them, and no edge leads into a
function whose ``module:qualname`` matches one of its patterns.

A **launch** is a call of a ctypes function taken from a ``_build.load``
library (directly, or through a module helper such as ``_kernel()`` that
loads it) with a tensor's ``.data_ptr()`` among its arguments.  A **kernel
wrapper** is a public module-level function of such a module from which a
launch is reachable inside the module: ``flash_attention``,
``decode_attention``, ``ssd_scan``, ``rg_lru`` and ``epoch_scan``.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .project import FuncNode, ModuleInfo, ProjectIndex, dotted_name


@dataclasses.dataclass(frozen=True)
class Unit:
    """One hot unit: a function whose whole subtree runs on the hot path."""
    mod: ModuleInfo
    node: FuncNode
    name: str           # qualname ("ServeEngine.step", "<lambda:L123>")

    def key(self) -> Tuple[str, int]:
        return (self.mod.path, self.node.lineno)


@dataclasses.dataclass
class ReachableSet:
    units: List[Unit]
    roots: List[str]            # ``module:qualname`` of every resolved root
    missing: List[str]          # configured roots the index does not hold

    def __iter__(self):
        return iter(self.units)


def is_build_load(dotted: Optional[str]) -> bool:
    """``_build.load`` of the port (any spelling that resolves to it)."""
    return bool(dotted) and (dotted == "_build.load"
                             or dotted.endswith("._build.load"))


def _loaders(mod: ModuleInfo) -> Set[str]:
    """Module-level functions of ``mod`` whose body calls ``_build.load``."""
    out = set()
    for name, fn in mod.functions.items():
        if any(isinstance(n, ast.Call) and is_build_load(dotted_name(n.func,
                                                                     mod))
               for n in ast.walk(fn)):
            out.add(name)
    return out


def _handles(fn: ast.AST, mod: ModuleInfo, loaders: Set[str]) -> Set[str]:
    """Names bound in ``fn`` to a ctypes library or one of its functions."""
    handles: Set[str] = set()

    def from_lib(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            d = dotted_name(expr.func, mod) or ""
            if is_build_load(d):
                return True
            if isinstance(expr.func, ast.Name) and expr.func.id in loaders:
                return True
            return False
        if isinstance(expr, (ast.Attribute, ast.Subscript)):
            return from_lib(expr.value)
        if isinstance(expr, ast.Name):
            return expr.id in handles
        if isinstance(expr, ast.IfExp):
            return from_lib(expr.body) or from_lib(expr.orelse)
        return False

    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                     key=lambda n: n.lineno)
    for _ in range(2):
        for st in assigns:
            if from_lib(st.value):
                for t in st.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            handles.add(n.id)
    return handles


def launch_calls(fn: ast.AST, mod: ModuleInfo,
                 loaders: Optional[Set[str]] = None) -> List[ast.Call]:
    """Calls in ``fn``'s own body that launch: a ctypes handle called with a
    ``.data_ptr()`` among its arguments."""
    loaders = _loaders(mod) if loaders is None else loaders
    handles = _handles(fn, mod, loaders)
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        head = node.func
        while isinstance(head, (ast.Attribute, ast.Subscript)):
            head = head.value
        if not (isinstance(head, ast.Name) and head.id in handles):
            continue
        args = list(node.args) + [k.value for k in node.keywords]
        if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "data_ptr"
               for a in args for n in ast.walk(a)):
            out.append(node)
    return out


def launching_functions(mod: ModuleInfo) -> Dict[str, List[ast.Call]]:
    """Module-level function name -> its launch calls (non-empty only)."""
    if "_build" not in mod.source:
        return {}
    loaders = _loaders(mod)
    out = {}
    for name, fn in mod.functions.items():
        calls = launch_calls(fn, mod, loaders)
        if calls:
            out[name] = calls
    return out


def local_callees(fn: ast.AST, mod: ModuleInfo) -> List[Tuple[str, ast.Call]]:
    """``(name, call)`` for calls in ``fn`` of module-level functions of the
    same module."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in mod.functions:
            out.append((node.func.id, node))
    return out


def launch_reach(mod: ModuleInfo) -> Set[str]:
    """Module-level functions of ``mod`` from which a launch is reachable
    inside the module (the launching ones included)."""
    reach = set(launching_functions(mod))
    changed = bool(reach)
    while changed:
        changed = False
        for name, fn in mod.functions.items():
            if name not in reach and any(
                    c in reach for c, _ in local_callees(fn, mod)):
                reach.add(name)
                changed = True
    return reach


def kernel_wrappers(index: ProjectIndex) -> List[Tuple[ModuleInfo, str]]:
    """Public module-level functions that reach a launch inside their module
    (``flash_attention``, ..., ``epoch_scan``)."""
    if "kernel_wrappers" in index.cache:
        return index.cache["kernel_wrappers"]
    out = []
    for mod in index.modules.values():
        out.extend((mod, name) for name in sorted(launch_reach(mod))
                   if not name.startswith("_"))
    out.sort(key=lambda mn: (mn[0].path, mn[0].functions[mn[1]].lineno))
    index.cache["kernel_wrappers"] = out
    return out


def _excluded(mod: ModuleInfo, fn: ast.AST, patterns: Sequence[str]) -> bool:
    spec = f"{mod.module}:{mod.qualname(fn)}"
    return any(fnmatch.fnmatchcase(spec, p) or
               fnmatch.fnmatchcase(mod.qualname(fn), p) for p in patterns)


def _callee_targets(expr: ast.AST, mod: ModuleInfo, index: ProjectIndex) \
        -> List[Tuple[ModuleInfo, FuncNode]]:
    """Resolve a callee expression to concrete function nodes."""
    if isinstance(expr, ast.Lambda):
        return [(mod, expr)]
    if isinstance(expr, ast.Call):                     # functools.partial(f,…)
        if dotted_name(expr.func, mod) == "functools.partial" and expr.args:
            return _callee_targets(expr.args[0], mod, index)
        return []
    local = mod.resolve_local(expr, expr)
    if local is not None:
        return [(mod, local)]
    if isinstance(expr, (ast.Name, ast.Attribute)):
        dotted = dotted_name(expr, mod)
        if dotted:
            hit = index.resolve_function(dotted)
            if hit is not None:
                return [hit]
    return []


def call_edges(unit_node: FuncNode, mod: ModuleInfo, index: ProjectIndex) \
        -> List[Tuple[ModuleInfo, FuncNode]]:
    """Functions this unit's subtree calls (or partial-wraps)."""
    out: List[Tuple[ModuleInfo, FuncNode]] = []
    for node in ast.walk(unit_node):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func, mod) == "functools.partial" and node.args:
            out.extend(_callee_targets(node.args[0], mod, index))
            continue
        out.extend(_callee_targets(node.func, mod, index))
    return out


def compute_reachable(index: ProjectIndex, roots: Sequence[str] = (),
                      exclude: Sequence[str] = ()) -> ReachableSet:
    """The hot set from the listed ``module:qualname`` roots and every kernel
    wrapper, never entering a function ``exclude`` matches."""
    frontier: List[Tuple[ModuleInfo, FuncNode]] = []
    resolved, missing = [], []
    for spec in roots:
        hit = index.resolve_qualname(spec)
        if hit is None:
            missing.append(spec)
            continue
        resolved.append(spec)
        frontier.append(hit)
    for mod, name in kernel_wrappers(index):
        resolved.append(f"{mod.module}:{name}")
        frontier.append((mod, mod.functions[name]))

    # BFS over call edges; each unit is scanned whole (nested defs included),
    # so membership is tracked at unit granularity
    seen: Set[Tuple[str, int]] = set()
    units: List[Unit] = []
    while frontier:
        mod, node = frontier.pop()
        if _excluded(mod, node, exclude):
            continue
        unit = Unit(mod=mod, node=node, name=mod.qualname(node))
        if unit.key() in seen:
            continue
        seen.add(unit.key())
        units.append(unit)
        for tgt_mod, tgt_node in call_edges(node, mod, index):
            if (tgt_mod.path, tgt_node.lineno) not in seen:
                frontier.append((tgt_mod, tgt_node))

    units.sort(key=lambda u: (u.mod.path, u.node.lineno))
    return ReachableSet(units=units, roots=resolved, missing=missing)
