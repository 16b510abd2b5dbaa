"""TX001–TX003 and KL001: the port's device contracts, the twins of JX001–JX003.

* **TX001 host-sync** — in the hot set (:mod:`.reachability`): ``.item()``,
  ``.tolist()``, ``.cpu()`` and ``.numpy()`` on a tensor, ``bool()`` /
  ``int()`` / ``float()`` of a tensor, an ``if``/``while`` whose test holds a
  tensor-valued ``torch.*`` call or a reduction (``.any()``, ``.sum()``, ...)
  of a tensor, and a ``synchronize()`` (of the device, a stream or an
  event).  Each one stops the host
  until the stream drains (JX001's tracer leak raises instead; eager torch
  silently waits).
* **TX002 host-numpy** — ``np.*`` calls fed tensor values in the hot set:
  an implicit copy to the host and a sync, and on a CUDA tensor numpy
  raises.
* **TX003 import-time effects** — at a module's top level (class bodies
  included, function bodies not): a kernel build (``_build.load``,
  ``_build.build_all``, ``torch.utils.cpp_extension.load*``), a
  ``subprocess``/``os.system`` call, a reference to ``nvcc``, the triton
  import statement, or a write to ``os.environ``; anywhere, a kernel build
  inside a loop body.  The static form of the tests that import every module
  and find no build and no changed environment.
* **KL001 launch-without-refuse-grad** — every path from a kernel wrapper
  (:func:`.reachability.kernel_wrappers`) to a ctypes launch calls
  ``_build.refuse_grad`` first, or runs under ``torch.no_grad()`` /
  ``torch.inference_mode()``: a launch writes an output autograd knows
  nothing of, so a loss taken through it would silently miss a gradient.  A
  call from another module into a kernel module's private launching helper
  (``_launch``) is a path of its own and is held to the same rule at its
  call site.  (JAX raises by itself when asked to differentiate a
  ``pallas_call`` with no VJP rule; the port has to ask.)

"Tensor value" is approximated by taint, as the reference's "traced value"
is: the parameters of hot functions, except ``self``/``cls``, those
annotated with a host type (``int``, ``float``, ``bool``, ``str``, their
``Optional``/``Tuple``/... forms, ``torch.device``, ``torch.dtype``, a
``*Config`` or ``*Spec``) and unannotated ones whose default is a constant;
and every name assigned from a tainted expression or from a tensor-valued
``torch.*`` call.  Shape metadata is never tainted: ``.shape``, ``.dtype``,
``.device``, ``.ndim``, ``.dim()``, ``.numel()``, ``.size()``,
``.stride()``, ``len()`` (the reference's ``_shape_safe``), nor are the
results of ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` (host values:
the sync was at the call).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding
from .project import ModuleInfo, ProjectIndex, dotted_name
from .reachability import (ReachableSet, Unit, kernel_wrappers,
                           launch_reach, launching_functions, local_callees)

_HOST_CASTS = ("bool", "int", "float")
_LEAK_METHODS = {"item", "tolist", "cpu", "numpy"}
#: attributes that read metadata, never the data
_SHAPE_SAFE_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                     "requires_grad", "layout", "is_leaf", "grad_fn",
                     "itemsize", "nbytes"}
#: methods that read metadata (or a pointer), never the data
_SHAPE_SAFE_METHODS = {"dim", "numel", "size", "stride", "element_size",
                       "data_ptr", "is_floating_point", "is_contiguous",
                       "get_device", "storage_offset", "nelement",
                       "is_complex", "ndimension"}
#: builtins whose result is never a tensor
_HOST_BUILTINS = {"len", "isinstance", "type", "id", "hasattr", "callable",
                  "repr", "str", "range", "enumerate", "zip", "sorted"}
#: ``torch.*`` calls that return host values
_TORCH_HOST = ("torch.is_grad_enabled", "torch.device", "torch.dtype",
               "torch.finfo", "torch.iinfo", "torch.is_tensor",
               "torch.is_floating_point", "torch.get_default_dtype",
               "torch.are_deterministic_algorithms_enabled",
               "torch.is_inference_mode_enabled", "torch.Size",
               "torch.Generator", "torch.no_grad", "torch.enable_grad",
               "torch.inference_mode", "torch.set_grad_enabled",
               "torch.get_num_threads", "torch.promote_types",
               "torch.result_type", "torch.can_cast")
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.version.",
                        "torch.distributed.", "torch.profiler.",
                        "torch.autograd.profiler.", "torch.utils.")
#: reductions and comparisons whose result, in an ``if``, is read on the host
_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin", "mean",
               "equal", "allclose", "eq", "ne", "lt", "gt", "le", "ge",
               "isnan", "isinf", "isfinite", "count_nonzero", "nonzero",
               "norm", "prod"}
#: annotation leaves that mark a host value
_HOST_TYPES = {"int", "float", "bool", "str", "bytes", "complex", "None",
               "Optional", "Tuple", "List", "Sequence", "Dict", "Union",
               "Iterable", "Mapping", "tuple", "list", "dict", "set",
               "frozenset", "Set", "FrozenSet", "Callable", "Path",
               "torch.device", "torch.dtype", "np.dtype", "Literal",
               "np.ndarray", "numpy.ndarray"}

_BUILD_CALLS = ("torch.utils.cpp_extension.load",
                "torch.utils.cpp_extension.load_inline", "triton.compile")
_SUBPROCESS = ("os.system", "os.popen", "os.spawnv", "os.execv")
_ENV_MUTATORS = {"update", "setdefault", "pop", "clear", "popitem",
                 "__setitem__", "__delitem__"}


def _is_build(dotted: Optional[str]) -> bool:
    if not dotted:
        return False
    return dotted in _BUILD_CALLS or dotted.endswith(
        ("._build.load", "._build.build_all")) or dotted in (
        "_build.load", "_build.build_all")


def _is_refuse_grad(dotted: Optional[str]) -> bool:
    return bool(dotted) and (dotted == "_build.refuse_grad"
                             or dotted.endswith("._build.refuse_grad"))


# -- taint -------------------------------------------------------------------

def _ann_leaves(ann: ast.AST) -> List[str]:
    """The type names an annotation is built from (``Optional[int]`` ->
    ``Optional``, ``int``; ``torch.device`` stays whole)."""
    if isinstance(ann, ast.Attribute):
        return [ast.unparse(ann)]
    if isinstance(ann, ast.Name):
        return [ann.id]
    if isinstance(ann, ast.Constant):
        if isinstance(ann.value, str) and ann.value:
            try:                                 # a string annotation
                return _ann_leaves(ast.parse(ann.value, mode="eval").body)
            except SyntaxError:
                return ["?"]
        return ["None"] if ann.value is None else []
    if isinstance(ann, ast.Subscript):
        if ast.unparse(ann.value).endswith("Literal"):
            return ["Literal"]                   # its values are host data
        return _ann_leaves(ann.value) + _ann_leaves(ann.slice)
    if isinstance(ann, (ast.Tuple, ast.List)):
        return [x for e in ann.elts for x in _ann_leaves(e)]
    if isinstance(ann, ast.BinOp):               # X | Y
        return _ann_leaves(ann.left) + _ann_leaves(ann.right)
    return ["?"]


def _ann_is_host(ann: ast.AST) -> bool:
    leaves = _ann_leaves(ann)
    return bool(leaves) and all(
        x in _HOST_TYPES or (x.endswith(("Config", "Spec")) and "Tensor"
                             not in x) for x in leaves)


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    names = []
    for p, default in pairs:
        if p.arg in ("self", "cls"):
            continue
        ann = getattr(p, "annotation", None)
        if ann is not None and _ann_is_host(ann):
            continue
        if ann is None and isinstance(default, ast.Constant) \
                and default.value is not None:
            continue
        names.append(p.arg)
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def torch_tensor_call(call: ast.Call, mod: ModuleInfo) -> bool:
    """A ``torch.*`` call that returns a tensor (not a host query)."""
    d = dotted_name(call.func, mod) or ""
    if not d.startswith("torch."):
        return False
    return d not in _TORCH_HOST and not d.startswith(_TORCH_HOST_PREFIXES)


class Taint:
    """The tensor-tainted names of one hot unit."""

    def __init__(self, unit_node: ast.AST, mod: ModuleInfo):
        self.mod = mod
        self.names: Set[str] = set()
        for node in ast.walk(unit_node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                self.names.update(_params(node))
        stmts = [n for n in ast.walk(unit_node)
                 if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                   ast.For, ast.withitem, ast.NamedExpr))]
        stmts.sort(key=lambda n: getattr(n, "lineno", 0))
        for _ in range(2):                   # cheap fixpoint, 2 passes
            for st in stmts:
                if isinstance(st, ast.For):
                    src, dsts = st.iter, [st.target]
                elif isinstance(st, ast.withitem):
                    src = st.context_expr
                    dsts = [st.optional_vars] if st.optional_vars else []
                elif isinstance(st, ast.Assign):
                    src, dsts = st.value, st.targets
                else:
                    src, dsts = st.value, [st.target]
                if src is None or not self.tensor(src):
                    continue
                for d in dsts:
                    for n in ast.walk(d):
                        if isinstance(n, ast.Name):
                            self.names.add(n.id)

    def tensor(self, expr: ast.AST, host: frozenset = frozenset()) -> bool:
        """Whether ``expr`` plausibly evaluates to (or reads) a tensor
        (``host``: names known not to hold one here)."""
        if isinstance(expr, ast.Name):
            return expr.id in self.names and expr.id not in host
        if isinstance(expr, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in _SHAPE_SAFE_ATTRS:
                return False
            return self.tensor(expr.value, host)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in _SHAPE_SAFE_METHODS | _LEAK_METHODS:
                return False
            if isinstance(f, ast.Name) and f.id in _HOST_BUILTINS:
                return False
            d = dotted_name(f, self.mod) or ""
            if d.startswith("torch."):
                return torch_tensor_call(expr, self.mod)
            return any(self.tensor(c, host)
                       for c in ast.iter_child_nodes(expr))
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        return any(self.tensor(c, host) for c in ast.iter_child_nodes(expr))

    def reduction_in(self, test: ast.AST) -> Optional[str]:
        """A tensor-valued ``torch.*`` call or a reduction of a tensor in an
        ``if``/``while`` test: the spelling, else None."""
        for n in ast.walk(test):
            if not isinstance(n, ast.Call):
                continue
            if torch_tensor_call(n, self.mod):
                return dotted_name(n.func, self.mod)
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _REDUCTIONS and self.tensor(n.func.value):
                return f".{n.func.attr}()"
        return None


def _is_tensor_check(test: ast.AST, mod: ModuleInfo) -> Optional[str]:
    """The name ``x`` of an ``isinstance(x, torch.Tensor)`` test."""
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) and \
            test.func.id == "isinstance" and len(test.args) == 2 and \
            isinstance(test.args[0], ast.Name) and \
            (dotted_name(test.args[1], mod) or "").endswith("Tensor"):
        return test.args[0].id
    return None


def host_narrowed(node: ast.AST, mod: ModuleInfo) -> frozenset:
    """Names an enclosing ``if`` proves are not tensors at ``node``: the
    body of ``if not isinstance(x, torch.Tensor)``, the ``else`` of ``if
    isinstance(x, torch.Tensor)``."""
    out = set()
    child, cur = node, mod.parents.get(node)
    while cur is not None and not isinstance(cur, ast.Module):
        if isinstance(cur, ast.If):
            test = cur.test
            negated = isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not)
            name = _is_tensor_check(test.operand if negated else test, mod)
            in_body = any(child is n for n in cur.body)
            in_else = any(child is n for n in cur.orelse)
            if name and ((negated and in_body) or (not negated and in_else)):
                out.add(name)
        child, cur = cur, mod.parents.get(cur)
    return frozenset(out)


# -- TX001 / TX002 -----------------------------------------------------------

def check_hot_rules(reach: ReachableSet, rules: Iterable[str],
                    sites: Dict[str, List[str]]) -> List[Finding]:
    rules = set(rules)
    raw: List[Finding] = []
    for unit in reach:
        raw.extend(_check_unit(unit, Taint(unit.node, unit.mod), rules,
                               sites))
    # a nested def can be both inside a hot unit and its own unit: report
    # each site once
    seen, out = set(), []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.code)):
        key = (f.code, f.path, f.line, f.col)
        if key not in seen:
            seen.add(key)
            out.append(f)
    for code in ("TX001", "TX002"):
        if code in sites:
            sites[code] = sorted(set(sites[code]))
    return out


def _check_unit(unit: Unit, taint: Taint, rules: Set[str],
                sites: Dict[str, List[str]]) -> List[Finding]:
    mod, out = unit.mod, []

    def site(code: str, node: ast.AST) -> None:
        if code in rules:
            sites.setdefault(code, []).append(f"{mod.path}:{node.lineno}")

    def emit(code: str, node: ast.AST, msg: str) -> None:
        if code in rules:
            out.append(Finding(code=code, path=mod.path, line=node.lineno,
                               col=node.col_offset,
                               message=f"{msg} [hot via `{unit.name}`]"))

    for node in ast.walk(unit.node):
        if isinstance(node, ast.Call):
            f = node.func
            d = dotted_name(f, mod) or ""
            # -- TX001: host syncs
            if isinstance(f, ast.Attribute) and f.attr in _LEAK_METHODS:
                site("TX001", node)
                if taint.tensor(f.value, host_narrowed(node, mod)):
                    emit("TX001", node,
                         f"`.{f.attr}()` on a tensor copies it to the host "
                         f"and waits for the stream")
            elif isinstance(f, ast.Name) and f.id in _HOST_CASTS \
                    and node.args:
                site("TX001", node)
                if taint.tensor(node.args[0], host_narrowed(node, mod)):
                    emit("TX001", node,
                         f"`{f.id}()` of a tensor reads it on the host (a "
                         f"sync); keep it a tensor or read it once outside "
                         f"the hot path")
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                site("TX001", node)
                emit("TX001", node,
                     f"`{ast.unparse(f)}()` stops the host until the card "
                     f"drains")
            # -- TX002: host numpy on tensors
            if d.startswith("numpy.") and not d.startswith("numpy.random."):
                site("TX002", node)
                host = host_narrowed(node, mod)
                if any(taint.tensor(a, host) for a in list(node.args)
                       + [k.value for k in node.keywords]):
                    emit("TX002", node,
                         f"host numpy call `{d}` on a tensor: an implicit "
                         f"copy to the host and a sync (it raises on a CUDA "
                         f"tensor); use the torch equivalent")
        if isinstance(node, (ast.If, ast.While)):
            site("TX001", node)
            what = taint.reduction_in(node.test)
            if what is not None:
                kw = "if" if isinstance(node, ast.If) else "while"
                emit("TX001", node,
                     f"`{kw}` on a tensor expression (`{what}`) reads it on "
                     f"the host (a sync); use torch.where or keep the "
                     f"decision on the host")
    return out


# -- TX003 -------------------------------------------------------------------

def _top_level_nodes(tree: ast.Module) -> Iterable[ast.AST]:
    """Every node that runs at import: module and class bodies, not the
    bodies of functions or lambdas (their decorators and defaults do run)."""
    stack: List[ast.AST] = [tree]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                stack.extend(getattr(child, "decorator_list", []))
                stack.extend(d for d in child.args.defaults
                             + child.args.kw_defaults if d is not None)
                continue
            yield child
            stack.append(child)


def _env_write(node: ast.AST, mod: ModuleInfo) -> Optional[str]:
    def is_environ(e: ast.AST) -> bool:
        return dotted_name(e, mod) == "os.environ"

    if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
        targets = node.targets if isinstance(node, (ast.Assign, ast.Delete)) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript) and is_environ(t.value):
                return "os.environ[...]"
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _ENV_MUTATORS \
                and is_environ(f.value):
            return f"os.environ.{f.attr}()"
        if dotted_name(f, mod) in ("os.putenv", "os.unsetenv"):
            return dotted_name(f, mod)
    return None


def check_import_rules(index: ProjectIndex,
                       sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        def emit(node: ast.AST, msg: str) -> None:
            out.append(Finding(code="TX003", path=mod.path, line=node.lineno,
                               col=node.col_offset, message=msg))

        for node in _top_level_nodes(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                if any(n == "triton" or n.startswith("triton.")
                       for n in names):
                    emit(node, "triton imported at module level: import it "
                               "inside the function that launches (the "
                               "CPU box has no triton)")
            env = _env_write(node, mod)
            if env is not None:
                emit(node, f"`{env}` at import changes the environment of "
                           f"every process that imports this module")
            if not isinstance(node, ast.Call):
                continue
            sites.setdefault("TX003", []).append(f"{mod.path}:{node.lineno}")
            d = dotted_name(node.func, mod) or ""
            if _is_build(d):
                emit(node, f"kernel build `{d}` at import: build at the "
                           f"first launch")
            elif d.startswith("subprocess.") or d in _SUBPROCESS:
                emit(node, f"`{d}` runs a process at import")
            elif d.endswith("nvcc") or any(
                    isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and "nvcc" in n.value for a in node.args
                    for n in ast.walk(a)):
                emit(node, "nvcc at import: kernels build at their first "
                           "launch")
        # builds inside loop bodies, anywhere
        for loop in mod.nodes:
            if isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                body = loop.body + loop.orelse
            elif isinstance(loop, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp, ast.DictComp)):
                body = [loop]
            else:
                continue
            for stmt in body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call) and \
                            _is_build(dotted_name(n.func, mod)):
                        emit(n, f"kernel build `{dotted_name(n.func, mod)}` "
                                f"inside a loop body: build once, outside "
                                f"the loop")
    dedup, final = set(), []
    for f in sorted(out, key=lambda f: (f.path, f.line, f.col, f.message)):
        if (f.path, f.line, f.col) not in dedup:
            dedup.add((f.path, f.line, f.col))
            final.append(f)
    return final


# -- KL001 -------------------------------------------------------------------

def _no_grad_ctx(expr: ast.AST, mod: ModuleInfo) -> bool:
    target = expr.func if isinstance(expr, ast.Call) else expr
    return dotted_name(target, mod) in ("torch.no_grad",
                                        "torch.inference_mode")


def _guarded(fn: ast.AST, call: ast.AST, mod: ModuleInfo) -> bool:
    """``fn`` calls ``_build.refuse_grad`` before ``call``, or ``call`` runs
    under ``torch.no_grad()`` / ``torch.inference_mode()``."""
    for dec in getattr(fn, "decorator_list", []):
        if _no_grad_ctx(dec, mod):
            return True
    cur = mod.parents.get(call)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.With, ast.AsyncWith)) and any(
                _no_grad_ctx(item.context_expr, mod) for item in cur.items):
            return True
        cur = mod.parents.get(cur)
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and _is_refuse_grad(
                dotted_name(n.func, mod)) and \
                (n.lineno, n.col_offset) < (call.lineno, call.col_offset):
            return True
    return False


def _unguarded_launch(mod: ModuleInfo, name: str,
                      launching: Dict[str, List[ast.Call]], reach: Set[str],
                      seen: Set[str]) -> Optional[ast.Call]:
    """The first launch reachable from ``mod.functions[name]`` by a path with
    no guard, else None."""
    if name in seen:
        return None
    seen = seen | {name}
    fn = mod.functions[name]
    for call in launching.get(name, []):
        if not _guarded(fn, call, mod):
            return call
    for callee, call in local_callees(fn, mod):
        if callee in reach and not _guarded(fn, call, mod):
            hit = _unguarded_launch(mod, callee, launching, reach, seen)
            if hit is not None:
                return hit
    return None


def check_launch_rules(index: ProjectIndex,
                       sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    private: Dict[str, Tuple[ModuleInfo, str]] = {}
    for mod, name in kernel_wrappers(index):
        sites.setdefault("KL001", []).append(f"{mod.module}:{name}")
    wrapped: Dict[str, Tuple[ModuleInfo, List[str]]] = {}
    for mod, name in kernel_wrappers(index):
        wrapped.setdefault(mod.module, (mod, []))[1].append(name)
    for mod, names in wrapped.values():
        launching = launching_functions(mod)
        reach = launch_reach(mod)
        for fname in reach:
            if fname.startswith("_"):
                private[f"{mod.module}.{fname}"] = (mod, fname)
        for name in names:
            hit = _unguarded_launch(mod, name, launching, reach, set())
            if hit is not None:
                fn = mod.functions[name]
                out.append(Finding(
                    code="KL001", path=mod.path, line=fn.lineno,
                    col=fn.col_offset,
                    message=f"kernel wrapper `{name}` reaches the ctypes "
                            f"launch on line {hit.lineno} without "
                            f"`_build.refuse_grad` first: under autograd "
                            f"the kernel's output would carry no "
                            f"gradient"))
    # calls from elsewhere into a kernel module's private launching helper
    for mod in index.modules.values():
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func, mod) or ""
            hit = private.get(d)
            if hit is None or hit[0] is mod:
                continue
            fn = mod.enclosing_function(node)
            sites.setdefault("KL001", []).append(f"{mod.path}:{node.lineno}")
            if fn is None or not _guarded(fn, node, mod):
                out.append(Finding(
                    code="KL001", path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"`{d.rsplit('.', 1)[-1]}` launches a kernel "
                            f"and is called here without "
                            f"`_build.refuse_grad` or `torch.no_grad()` "
                            f"first"))
    out.sort(key=lambda f: (f.path, f.line, f.col))
    return out

