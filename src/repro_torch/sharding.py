"""Logical-axis sharding rules (MaxText-style) for the whole framework.

The twin of ``src/repro/sharding.py``.  Model code declares parameters with
*logical* axis names ("batch", "embed", "mlp", "heads", "kv", "vocab",
"expert", "seq", ...).  A launcher installs a rule set mapping logical names
to mesh axes; with no rules installed every mapping is empty.

The port runs on one device, so nothing here places a tensor: :class:`Mesh`
is an abstract mesh (axis names and sizes, no devices) and :class:`P` a plain
tuple, the stand-ins for ``jax.sharding.Mesh`` and ``PartitionSpec``.  They
describe a layout — the dry-run sizes a cell's per-device bytes from them,
``models/pipeline.py`` takes its stage count from the mesh's ``pod`` axis —
while every shard lives on the one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


class P(tuple):
    """A partition spec: one entry per leading dimension, each ``None``, a
    mesh axis name or a tuple of names (the twin of ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An abstract device mesh: axis names and sizes, no devices."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh {self.axis_sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_STATE, "rules", None)


def _mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


# Default rule sets -----------------------------------------------------------

def rules_single_pod() -> Dict[str, MeshAxes]:
    """16×16 (data, model) single-pod mesh."""
    return {
        "batch": "data",
        "kv_batch": "data",      # KV-cache batch dim (can differ from batch:
                                 # weight-stationary decode replicates batch
                                 # activations but keeps the cache sharded)
        "fsdp": "data",          # weight shard axis for gather-on-use FSDP
        "model": "model",        # TP axis: heads / mlp / vocab / experts
        "expert": "model",       # MoE expert parallelism
        "seq": None,             # sequence usually replicated (flag-controlled)
        "kv_seq": "model",       # decode KV-cache sequence dim (flash-decode)
        "q_seq": "model",        # blocked-attention query rows (context par.)
    }


def rules_multi_pod() -> Dict[str, MeshAxes]:
    """2×16×16 (pod, data, model) mesh: DP and FSDP span pod×data."""
    r = rules_single_pod()
    r["batch"] = ("pod", "data")
    r["fsdp"] = ("pod", "data")
    return r


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, MeshAxes]] = None):
    """Install mesh + logical rules for this thread, restored on exit."""
    old_rules, old_mesh = _rules(), _mesh()
    _STATE.rules = rules
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.rules = old_rules
        _STATE.mesh = old_mesh


def logical_to_pspec(axes: Sequence[Optional[str]]) -> P:
    """Map logical axis names to a :class:`P` under the installed rules."""
    rules = _rules()
    if rules is None:
        return P()
    out = [rules.get(a) if a is not None else None for a in axes]
    while out and out[-1] is None:          # drop trailing Nones
        out.pop()
    return P(*out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: returns ``x`` unchanged.

    One device holds every shard, so there is no constraint to place; the
    reference also returns ``x`` when no mesh is installed."""
    return x


def named_sharding(axes: Sequence[Optional[str]]
                   ) -> Optional[Tuple[Mesh, P]]:
    """(installed mesh, spec of ``axes``), or ``None`` without a mesh."""
    mesh = _mesh()
    if mesh is None:
        return None
    return mesh, logical_to_pspec(axes)


def current_mesh() -> Optional[Mesh]:
    return _mesh()


def mesh_axis(logical: str):
    """(mesh axis name(s), total size) the logical axis maps to, or (None, 1)."""
    rules, mesh = _rules(), _mesh()
    if rules is None or mesh is None:
        return None, 1
    ax = rules.get(logical)
    if ax is None:
        return None, 1
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return axes, size


def shard_shape(shape: Sequence[int], spec: P, mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` laid out by ``spec`` on ``mesh``: a
    dimension split over mesh axes of total size k keeps ceil(d/k) rows."""
    out = []
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        out.append(-(-int(d) // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


# Lane meshes — 1-D device meshes for embarrassingly-parallel lane axes ------

LANE_AXIS = "lanes"


def lane_mesh(devices: Optional[Sequence[torch.device]] = None
              ) -> Optional[Mesh]:
    """The reference's 1-D lane mesh over the local devices: ``None`` on one
    device, so callers take the unsharded path.  Lane sharding over several
    CUDA cards cannot be checked on a one-card machine and raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    else:
        n = len(tuple(devices))
    if n <= 1:
        return None
    raise NotImplementedError(
        f"lane sharding over {n} CUDA devices: the port resolves every lane "
        "grid to one card (scenario/shardexec.py resolve_mesh)")


def lane_count(mesh: Optional[Mesh]) -> int:
    """Devices along the lane axis (1 when unsharded)."""
    return 1 if mesh is None else int(mesh.shape[LANE_AXIS])
