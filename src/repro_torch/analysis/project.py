"""AST project index — parse once, resolve imports, never import the target.

The twin of ``src/repro/analysis/project.py``.  The rules run on syntax trees
alone (``ast.parse``), so auditing ``repro_torch.kernels.flash_attention``
neither imports torch nor builds a kernel.  :class:`ProjectIndex` maps every
``.py`` file under the configured paths to a :class:`ModuleInfo` carrying its
tree, import aliases resolved to dotted module names, top-level
functions/classes, a child->parent node map, and every function by its
qualified name (``f``, ``Class.method``, ``outer.<locals>.inner``: Python's
own ``__qualname__``).

Beyond the reference, :meth:`ProjectIndex.resolve_function` resolves methods
(``module.Class.method``) and follows re-exports (``from .x import f`` in a
package ``__init__``), and :meth:`ModuleInfo.resolve_local` resolves a callee
inside a function to a def nested in an enclosing scope or, for
``self.m(...)``, to the enclosing class's method ``m``: the port's hot code
lives in methods and closures.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

FuncNode = ast.AST      # FunctionDef | AsyncFunctionDef | Lambda
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass
class ModuleInfo:
    path: str                               # repo-relative, posix
    module: str                             # dotted name, e.g. repro_torch.core.dvfs
    tree: ast.Module
    source: str
    imports: Dict[str, str]                 # alias -> dotted module
    from_imports: Dict[str, Tuple[str, str]]  # name -> (module, original)
    functions: Dict[str, ast.FunctionDef]   # top-level defs
    classes: Dict[str, ast.ClassDef]        # top-level classes
    global_names: frozenset                 # module-level assigned names
    parents: Dict[ast.AST, ast.AST]         # child -> parent
    qualnames: Dict[str, ast.AST]           # qualname -> def (all depths)
    nodes: List[ast.AST]                    # every node, in ast.walk order
    _nested: Dict[ast.AST, Dict[str, ast.AST]] = dataclasses.field(
        default_factory=dict, repr=False)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_class(self, fn: ast.AST) -> Optional[ast.ClassDef]:
        """The class ``fn`` is a method of (its direct parent), if any."""
        parent = self.parents.get(fn)
        return parent if isinstance(parent, ast.ClassDef) else None

    def qualname(self, fn: ast.AST) -> str:
        """``Class.method`` / ``outer.<locals>.inner`` / ``<lambda:L12>``."""
        if isinstance(fn, ast.Lambda):
            return f"<lambda:L{fn.lineno}>"
        parts = [fn.name]
        cur = self.parents.get(fn)
        while cur is not None and not isinstance(cur, ast.Module):
            if isinstance(cur, _DEFS):
                parts.append("<locals>")
                parts.append(cur.name)
            elif isinstance(cur, ast.ClassDef):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def nested_def(self, name: str, at: ast.AST) -> Optional[ast.AST]:
        """A def named ``name`` nested in a function enclosing ``at`` (the
        innermost scope wins, as Python's own lookup)."""
        scope = self.enclosing_function(at)
        while scope is not None:
            defs = self._nested.get(scope)
            if defs is None:
                defs = self._nested[scope] = {}
                for n in ast.walk(scope):
                    if isinstance(n, _DEFS) and n is not scope:
                        defs.setdefault(n.name, n)
            if name in defs:
                return defs[name]
            scope = self.enclosing_function(scope)
        return None

    def resolve_local(self, func: ast.AST, at: ast.AST) -> Optional[ast.AST]:
        """The callee ``func`` (seen at node ``at``) as a def nested in an
        enclosing scope or, for ``self.m``, the enclosing class's method."""
        if isinstance(func, ast.Name):
            return self.nested_def(func.id, at)
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in ("self", "cls"):
            scope = self.enclosing_function(at)
            while scope is not None:
                cls = self.enclosing_class(scope)
                if cls is not None:
                    return method_of(cls, func.attr)
                scope = self.enclosing_function(scope)
        return None


def method_of(cls: ast.ClassDef, name: str) -> Optional[ast.AST]:
    for stmt in cls.body:
        if isinstance(stmt, _DEFS) and stmt.name == name:
            return stmt
    return None


def module_name_for(relpath: Path) -> str:
    """Dotted module name for a repo-relative path (``src`` layout aware)."""
    parts = list(relpath.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_relative(module: str, level: int, target: Optional[str],
                      is_package: bool = False) -> str:
    """Resolve ``from ..x import y`` against the importing module's package
    (a package's ``__init__`` is its own package: level 1 stays in it)."""
    base = module.split(".")
    drop = level - 1 if is_package else level
    base = base[:len(base) - drop] if drop <= len(base) else []
    if target:
        base += target.split(".")
    return ".".join(base)


class ProjectIndex:
    """All parsed modules, addressable by dotted name or path."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        self.cache: Dict[str, object] = {}  # whole-index results rules share

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, root: Path, paths: Iterable[str],
              exclude: Tuple[str, ...] = ("tests/fixtures",)) -> \
            "ProjectIndex":
        idx = cls(root)
        for files_root in paths:
            base = (Path(root) / files_root).resolve()
            if base.is_file():
                idx.add_file(base)
                continue
            if not base.is_dir():
                continue
            for py in sorted(base.rglob("*.py")):
                rel = py.relative_to(root).as_posix()
                if any(rel.startswith(e) for e in exclude):
                    continue
                idx.add_file(py)
        return idx

    def add_file(self, path: Path) -> Optional[ModuleInfo]:
        path = Path(path).resolve()
        try:
            rel = path.relative_to(self.root).as_posix()
        except ValueError:
            rel = path.as_posix()
        if rel in self.by_path:
            return self.by_path[rel]
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError:
            return None
        mod = _build_module(rel, tree, source)
        self.modules[mod.module] = mod
        self.by_path[rel] = mod
        return mod

    # -- resolution ---------------------------------------------------------
    def resolve_module(self, dotted: str) -> Optional[ModuleInfo]:
        return self.modules.get(dotted)

    def resolve_function(self, dotted: str, _hops: int = 0) -> \
            Optional[Tuple[ModuleInfo, ast.AST]]:
        """``pkg.mod.f`` / ``pkg.mod.Class.method`` -> (module, def) if
        indexed, through re-exports (``from .mod import f`` in ``pkg``)."""
        if "." not in dotted or _hops > 8:
            return None
        mod_name, func = dotted.rsplit(".", 1)
        mod = self.modules.get(mod_name)
        if mod is not None:
            if func in mod.functions:
                return mod, mod.functions[func]
            if func in mod.from_imports:
                src, orig = mod.from_imports[func]
                return self.resolve_function(f"{src}.{orig}", _hops + 1)
            return None
        if "." in mod_name:                    # pkg.mod.Class.method
            owner, cls_name = mod_name.rsplit(".", 1)
            mod = self.modules.get(owner)
            if mod is not None and cls_name in mod.classes:
                fn = method_of(mod.classes[cls_name], func)
                if fn is not None:
                    return mod, fn
        return None

    def resolve_qualname(self, spec: str) -> Optional[Tuple[ModuleInfo,
                                                            ast.AST]]:
        """``module:qualname`` (a hot-set root) -> (module, def)."""
        mod_name, _, qual = spec.partition(":")
        mod = self.modules.get(mod_name)
        if mod is None or qual not in mod.qualnames:
            return None
        return mod, mod.qualnames[qual]


def _build_module(rel: str, tree: ast.Module, source: str) -> ModuleInfo:
    module = module_name_for(Path(rel))
    is_package = Path(rel).stem == "__init__"
    imports: Dict[str, str] = {}
    from_imports: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
                if a.asname:
                    imports[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            src = node.module or ""
            if node.level:
                src = _resolve_relative(module, node.level, node.module,
                                        is_package)
            for a in node.names:
                if a.name == "*":
                    continue
                from_imports[a.asname or a.name] = (src, a.name)

    functions = {n.name: n for n in tree.body if isinstance(n, _DEFS)}
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    global_names = set()
    for n in tree.body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    global_names.add(t.id)
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) and \
                isinstance(n.target, ast.Name):
            global_names.add(n.target.id)

    parents: Dict[ast.AST, ast.AST] = {}
    nodes = list(ast.walk(tree))
    for parent in nodes:
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    mod = ModuleInfo(path=rel, module=module, tree=tree, source=source,
                     imports=imports, from_imports=from_imports,
                     functions=functions, classes=classes,
                     global_names=frozenset(global_names), parents=parents,
                     qualnames={}, nodes=nodes)
    for node in nodes:
        if isinstance(node, _DEFS):
            mod.qualnames.setdefault(mod.qualname(node), node)
    return mod


# --------------------------------------------------------------------------
# Dotted-name resolution of expressions (through the import aliases)
# --------------------------------------------------------------------------

#: well-known aliases normalised even without seeing the import (defensive:
#: fixtures and repos conventionally use these spellings)
_CANON = {"np": "numpy"}


def dotted_name(node: ast.AST, mod: ModuleInfo) -> Optional[str]:
    """Resolve ``Name``/``Attribute`` chains to a dotted path.

    ``np.mean`` -> ``numpy.mean``; ``_build.load`` (``from . import
    _build``) -> ``repro_torch.kernels._build.load``; ``quanta``
    (from-import) -> ``repro_torch.kernels.epoch_scan.quanta``; plain local
    names resolve to ``<module>.<name>`` when the module defines them at top
    level.
    """
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    head = cur.id
    parts.reverse()
    if head in mod.from_imports:
        src, orig = mod.from_imports[head]
        base = f"{src}.{orig}" if src else orig
    elif head in mod.imports:
        base = mod.imports[head]
    elif head in mod.functions or head in mod.classes or \
            head in mod.global_names:
        base = f"{mod.module}.{head}" if mod.module else head
    else:
        base = head
    first = base.split(".")[0]
    if first in _CANON:
        base = ".".join([_CANON[first]] + base.split(".")[1:])
    return ".".join([base] + parts) if parts else base
