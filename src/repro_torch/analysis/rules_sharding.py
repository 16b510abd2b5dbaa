"""SH001 — lane-sharding contracts, on the port's own ``sharding.P``.

The twin of ``src/repro/analysis/rules_sharding.py``.  The port's
``repro_torch.sharding`` keeps the reference's layout vocabulary (``P`` is
a tuple, a layout's ``Mesh`` abstract; ``lane_mesh`` keeps the devices a
sweep's lane blocks run on, ``None`` on one); its conventions are
checkable:

* **leading lane axis** — stacked lane leaves shard along their leading
  axis, ``P("lanes")``; a ``P`` that names the lane axis at another
  position splits a per-lane tensor inside a lane;
* **no mesh construction in the hot set** — ``sharding.lane_mesh``,
  ``sharding.Mesh(...)``, anything of ``launch.mesh`` or a
  ``torch.distributed`` device mesh enumerates devices, a host effect that
  belongs before the launch, not inside a function the hot path runs per
  step.

The first check is module-wide (a wrong spec is wrong wherever it is
written); the second runs over the hot set.  Heuristics over conventions,
so SH001 defaults to ``warn`` (it gates under ``--strict``), as the
reference's does.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .findings import Finding
from .project import ModuleInfo, ProjectIndex, dotted_name
from .reachability import ReachableSet

#: the lane axis name used by ``repro_torch.sharding``
LANE_AXIS = "lanes"

_MESH_SUFFIXES = (".sharding.lane_mesh", ".sharding.Mesh")
_MESH_CALLS = ("torch.distributed.device_mesh.init_device_mesh",
               "torch.distributed.device_mesh.DeviceMesh")


def _is_pspec(dotted: Optional[str]) -> bool:
    return bool(dotted) and (dotted == "sharding.P"
                             or dotted.endswith(".sharding.P"))


def _is_mesh_ctor(dotted: Optional[str]) -> bool:
    if not dotted:
        return False
    return dotted.endswith(_MESH_SUFFIXES) or dotted in _MESH_CALLS \
        or ".launch.mesh." in dotted or dotted.startswith("launch.mesh.")


def check_sharding_rules(index: ProjectIndex, reach: ReachableSet,
                         sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        out.extend(_check_pspec_literals(mod, sites))
    for unit in reach:
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func, unit.mod)
            if _is_mesh_ctor(dotted):
                out.append(Finding(
                    code="SH001", path=unit.mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"`{dotted}` builds a mesh inside hot "
                            f"`{unit.name}` — device enumeration is a host "
                            f"effect; resolve the mesh before the launch"))
    dedup, final = set(), []
    for f in sorted(out, key=lambda f: (f.path, f.line, f.col, f.message)):
        key = (f.path, f.line, f.message)
        if key not in dedup:
            dedup.add(key)
            final.append(f)
    return final


def _check_pspec_literals(mod: ModuleInfo,
                          sites: Dict[str, List[str]]) -> List[Finding]:
    out: List[Finding] = []
    for node in mod.nodes:
        if not isinstance(node, ast.Call) or \
                not _is_pspec(dotted_name(node.func, mod)):
            continue
        sites.setdefault("SH001", []).append(f"{mod.path}:{node.lineno}")
        pos = _lane_axis_position(node)
        if pos is not None and pos > 0:
            out.append(Finding(
                code="SH001", path=mod.path, line=node.lineno,
                col=node.col_offset,
                message=f"P names the lane axis {LANE_AXIS!r} at position "
                        f"{pos} — stacked lane leaves shard along their "
                        f"leading axis (P({LANE_AXIS!r}))"))
    return out


def _lane_axis_position(call: ast.Call) -> Optional[int]:
    for i, a in enumerate(call.args):
        if isinstance(a, ast.Constant) and a.value == LANE_AXIS:
            return i
        if isinstance(a, (ast.Tuple, ast.List)):
            for e in a.elts:
                if isinstance(e, ast.Constant) and e.value == LANE_AXIS:
                    return i
    return None
