"""Logical-axis sharding rules (MaxText-style) for the whole framework.

The twin of ``src/repro/sharding.py``.  Model code declares parameters with
*logical* axis names ("batch", "embed", "mlp", "heads", "kv", "vocab",
"expert", "seq", ...).  A launcher installs a rule set mapping logical names
to mesh axes; with no rules installed every mapping is empty.

:class:`Mesh` is an abstract mesh (axis names and sizes, no devices) and
:class:`P` a plain tuple, the stand-ins for ``jax.sharding.Mesh`` and
``PartitionSpec``.  They describe a layout — the dry-run sizes a cell's
per-device bytes from them, ``models/pipeline.py`` takes its stage count from
the mesh's ``pod`` axis — while every shard of a one-card run lives on the
card.  A *device* mesh (``torch.distributed``'s ``DeviceMesh``, installed by
``use_mesh(..., device_mesh=...)``) is what places tensors: the dry-run's
partitioned count runs a step on ``DTensor`` arguments over one, and then
:func:`shard` constrains an activation's layout as the reference's
``with_sharding_constraint`` does.  ``torch.distributed`` is imported only
inside the functions that need a device mesh.

The *lane* mesh (:func:`lane_mesh`) is another thing: a 1-D mesh that keeps
its devices, over which ``scenario.shardexec`` splits a sweep's independent
lanes, one contiguous block a device.  Its devices are the process's CUDA
cards, or one device N times under :func:`virtual_lane_devices`.
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
    """A device mesh: axis names and sizes.  A layout's mesh is abstract (no
    devices); a lane mesh (:func:`lane_mesh`) keeps its devices, row-major."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh {self.axis_sizes} vs axes {self.axis_names}")
        if self.devices and len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"mesh {self.axis_sizes} over "
                             f"{len(self.devices)} devices")

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


def _device_mesh():
    return getattr(_STATE, "device_mesh", None)


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
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, MeshAxes]] = None,
             device_mesh=None):
    """Install mesh + logical rules for this thread, restored on exit.
    ``device_mesh``: a ``DeviceMesh`` with ``mesh``'s axis names and sizes,
    over which :func:`shard` places ``DTensor`` activations."""
    if device_mesh is not None and (
            mesh is None
            or tuple(device_mesh.mesh_dim_names) != mesh.axis_names
            or tuple(device_mesh.shape) != mesh.axis_sizes):
        raise ValueError(f"device mesh {device_mesh} does not match {mesh}")
    old = _rules(), _mesh(), _device_mesh()
    _STATE.rules, _STATE.mesh, _STATE.device_mesh = rules, mesh, device_mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh, _STATE.device_mesh = old


def logical_to_pspec(axes: Sequence[Optional[str]]) -> P:
    """Map logical axis names to a :class:`P` under the installed rules."""
    rules = _rules()
    if rules is None:
        return P()
    out = [rules.get(a) if a is not None else None for a in axes]
    while out and out[-1] is None:          # drop trailing Nones
        out.pop()
    return P(*out)


def _names(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axis names of one spec entry."""
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P, mesh: Mesh) -> tuple:
    """One ``Shard(dim)`` / ``Replicate()`` per axis of ``mesh`` for a
    tensor laid out by ``spec``.  A tuple entry shards its dimension on each
    named mesh axis; the blocks are then ordered as ``PartitionSpec``'s are,
    so the names must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        names = _names(entry)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {names} not in the order of "
                             f"{mesh.axis_names}")
        for i in idx:
            if mesh.axis_sizes[i] > 1:    # an axis of one device splits nothing
                out[i] = Shard(dim)
    return tuple(out)


def on_device_mesh(x) -> bool:
    """True when a device mesh is installed and ``x`` is a ``DTensor``."""
    if _device_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def layout(shape: Sequence[int], *axes: Optional[str]) -> tuple:
    """The placements the installed rules give logical ``axes`` on the
    installed mesh, for a tensor of ``shape`` (:func:`even_spec`)."""
    mesh = _mesh()
    return placements(even_spec(shape, logical_to_pspec(axes), mesh), mesh)


def is_split(x: torch.Tensor, *dims: int) -> bool:
    """True when a device mesh is installed and ``x`` is a ``DTensor`` split
    over one of ``dims`` (a ``Partial`` sum is not a split)."""
    if not on_device_mesh(x):
        return False
    from torch.distributed.tensor import Shard
    dims = {d % x.ndim for d in dims}
    return any(isinstance(pl, Shard) and pl.dim in dims
               for pl in x.placements)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain an activation's layout to its logical axes.

    Without a device mesh (one card, every test) this returns ``x``
    unchanged, as the reference's does without a mesh.  With one, a
    ``DTensor`` is redistributed to the layout the installed rules give
    ``axes`` (the twin of ``with_sharding_constraint``): the collectives
    that takes are the step's.  A dimension the named axes do not divide
    stays whole over them (:func:`even_spec`)."""
    if not on_device_mesh(x):
        return x
    mesh = _mesh()
    spec = even_spec(x.shape, logical_to_pspec(axes), mesh)
    return x.redistribute(_device_mesh(), placements(spec, mesh))


def even_spec(shape: Sequence[int], spec: P, mesh: Mesh) -> P:
    """``spec`` with every dimension its mesh axes do not divide left
    whole: how a ``DTensor`` holds a layout that XLA would pad (DTensor's
    decompositions — an ``einsum``'s reshapes — refuse uneven splits)."""
    out = list(spec)
    for d, entry in enumerate(out):
        if shape[d] % math.prod(mesh.shape[a] for a in _names(entry)):
            out[d] = None
    return P(*out)


def _view_groups(old: Sequence[int], new: Sequence[int]):
    """The reshape ``old`` -> ``new`` as groups (input dims, output dims) of
    equal products, in order; size-1 dims join the group they precede."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        ins, outs, pa, pb = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                ins.append(i)
                pa *= old[i]
                i += 1
            else:
                outs.append(j)
                pb *= new[j]
                j += 1
        groups.append((ins, outs))
    if groups:                      # trailing size-1 dims
        groups[-1][0].extend(range(i, len(old)))
        groups[-1][1].extend(range(j, len(new)))
    return groups


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)`` (no ``-1``).  On a device mesh, a dimension split over mesh
    axes that the reshape cannot keep split — a split whose first factor
    those axes' sizes do not divide (heads·Dh into 2 KV heads on a 4-way
    axis), a merge led by a dimension they do not divide, or led by another
    dimension — is gathered first: the layout XLA's partitioner falls back
    to for the same reshape (it replicates the tensor over those axes).  The
    gradient is brought to the result's layout in the backward.  Without a
    device mesh, the plain reshape."""
    if not on_device_mesh(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    old, shape = tuple(x.shape), tuple(shape)
    mesh, pls = x.device_mesh, list(x.placements)
    for ins, outs in _view_groups(old, shape):
        if len(ins) == 1 and len(outs) == 1:
            continue
        split = [i for i, pl in enumerate(pls)
                 if isinstance(pl, Shard) and pl.dim in ins]
        if not split:
            continue
        k = math.prod(mesh.size(i) for i in split)
        lead = {pls[i].dim for i in split}
        keep = lead == {ins[0]} and (
            shape[outs[0]] % k == 0 if len(ins) == 1 else
            len(outs) == 1 and old[ins[0]] % k == 0)
        if not keep:
            for i in split:
                pls[i] = Replicate()
    if pls != list(x.placements):
        x = x.redistribute(mesh, pls)
    out = x.reshape(shape)
    # a no-op forward whose backward brings the gradient to ``out``'s
    # layout, so the reshape's backward sees a split it can keep
    return out.redistribute(mesh, out.placements)


def pinned(p: torch.Tensor) -> torch.Tensor:
    """``p`` for one of its uses.  On a device mesh, a no-op whose backward
    brings this use's gradient to ``p``'s layout, so the gradients of a
    tensor used twice (tied embeddings) add in one layout (some DTensor
    versions cannot add two others); otherwise ``p`` itself."""
    if not on_device_mesh(p):
        return p
    return p.redistribute(p.device_mesh, p.placements)


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient placed as its parameter (on a device mesh: the
    data-parallel reduction of a partial sum; otherwise ``g`` itself)."""
    if not on_device_mesh(g):
        return g
    return g.redistribute(p.device_mesh, p.placements)


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
        axes = _names(spec[i] if i < len(spec) else None)
        out.append(-(-int(d) // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


# Lane meshes — 1-D device meshes for embarrassingly-parallel lane axes ------

LANE_AXIS = "lanes"

# the process's virtual lane devices (None: the devices it has)
_VIRTUAL_LANES: Optional[int] = None


@contextlib.contextmanager
def virtual_lane_devices(n: int):
    """N virtual lane devices for the whole process, restored on exit: the
    twin of the reference's virtual host devices
    (``--xla_force_host_platform_device_count=N``).  Under it the lane
    devices of a sweep on device ``d`` are ``d`` N times, each one shard of
    the lane axis (on a CUDA device each shard runs on its own stream)."""
    global _VIRTUAL_LANES
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"virtual lane devices: a positive count, got {n!r}")
    old, _VIRTUAL_LANES = _VIRTUAL_LANES, n
    try:
        yield
    finally:
        _VIRTUAL_LANES = old


def lane_devices(device=None) -> Tuple[torch.device, ...]:
    """The lane devices of a sweep on ``device`` (default: the current CUDA
    device where there is one, else the CPU): ``device`` N times under
    :func:`virtual_lane_devices`, else every CUDA device of the process for a
    CUDA ``device`` and the one CPU for a CPU one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if _VIRTUAL_LANES is not None:
        return (dev,) * _VIRTUAL_LANES
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def lane_mesh(devices: Optional[Sequence[torch.device]] = None
              ) -> Optional[Mesh]:
    """A 1-D mesh over ``devices`` (default :func:`lane_devices`), axis name
    :data:`LANE_AXIS`, that keeps its devices, one shard each.

    The sweep grids are embarrassingly parallel along their leading
    design/policy lane axis, so a flat 1-D mesh is the whole story.  Returns
    ``None`` on a single device, as the reference does: callers fall back to
    the unsharded path.
    """
    devices = tuple(torch.device(d) for d in (
        lane_devices() if devices is None else devices))
    if len(devices) <= 1:
        return None
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a lane mesh over one kind of device, got {devices}")
    return Mesh((len(devices),), (LANE_AXIS,), devices=devices)


def lane_count(mesh: Optional[Mesh]) -> int:
    """Devices along the lane axis (1 when unsharded)."""
    return 1 if mesh is None else int(mesh.shape[LANE_AXIS])
