"""Sharded and chunked lane execution for sweep grids, on PyTorch (DESIGN.md
§13).

The twin of ``src/repro/scenario/shardexec.py``.  A sweep's grid is
embarrassingly parallel along its *lane* axis: the stacked design axis of
``SimTables`` (static and fault sweeps) or, when the policy grid is the wide
one, the stacked :class:`~repro_torch.core.dvfs.PolicyLanes` axis (dynamic
DTPM sweeps).  This module scales that axis two ways, composably:

* **lane sharding** — over a 1-D lane mesh (``repro_torch.sharding.
  lane_mesh``), each chunk of ``width`` lanes splits into one contiguous
  block of ``width / devices`` lanes a mesh device.  Every block is copied to
  its device and launched there on a stream of its own (one K1 launch plus
  its epilogue and thermal grid), all blocks of a chunk before any output
  comes back; the outputs are then copied to the host in lane order.  The
  mesh's devices are the process's CUDA cards, or one device N times under
  ``sharding.virtual_lane_devices(N)`` (N blocks on N streams of one card,
  or one after another on the CPU).  Lanes are independent, so every output
  equals the unsharded sweep's bit for bit.
* **chunked streaming** — ``sweep(..., chunk=N)`` streams the lane axis
  through the same grid programs in fixed-width chunks: the lane stacks stay
  on the host (pinned for a CUDA device, ``dse.batch.stack_tables(
  host=True)``), and each chunk's outputs come back to the host before the
  next chunk goes in — so the device holds one chunk's tables, K1 scratch and
  outputs at a time, not the grid's.

Chunk widths are pinned: the lane count (or ``chunk``) rounded up to the
mesh's device count, the last chunk padded up to the width by repeating its
lane 0, so every chunk's launches have the same lane count and scratch size.
Unlike ``dse.batch``'s in-kernel inert padding (1e30 latency, zero power),
pad lanes here are ordinary simulations whose outputs are sliced off — inert
because lanes never interact.  Inside a block the lanes stay design-major
(``dse.batch.to_design_major``), so K1 reads a lane's design as it does
unchunked and every lane equals its unchunked self bit for bit.

A chunk counts what the reference's does: N designs for static and fault
sweeps, N of the wider of designs and policies for DTPM ones.  The inputs
every block reads whole (the workload, the fault plans, and the whole table
stack when policies stream) are copied once a device; a block's stream
waits for them and holds them until it is done (``record_stream``).

Telemetry (``sweep(..., telemetry=True)``): each block's lanes are replayed
on its device and stream right after its launch, before its outputs go back
(``telemetry``, the sweep's replay callable), so the timelines equal the
unsharded sweep's bit for bit: a lane's replay reads only that lane.

Observability: ``scenario.shard.devices`` (lane-mesh width of the most
recent streamed grid), ``scenario.shard.pad_lanes`` (pad lanes added) and
``scenario.sweep.chunks`` (chunks streamed, not blocks) in the
``obs.metrics`` registry.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dvfs import PolicyLanes
from ..core.simkernel_torch import ARRAY_FIELDS, SimTables
from ..dse.batch import host_tensor
from ..obs import metrics as _metrics
from ..sharding import lane_count, lane_mesh

# lane-mesh width of the most recent streamed grid (1 = unsharded)
shard_devices = _metrics.counter("scenario.shard.devices")
# cumulative pad lanes added for chunk/device-count divisibility
shard_pad_lanes = _metrics.counter("scenario.shard.pad_lanes")
# cumulative fixed-width chunks streamed through the grid programs
sweep_chunks = _metrics.counter("scenario.sweep.chunks")


def padded_width(lanes: int, chunk: Optional[int], quantum: int) -> int:
    """The pinned per-chunk lane width: ``chunk`` (or all lanes) rounded up
    to the device-count quantum.  Fixed across chunks and across grids of
    different lane counts when ``chunk`` is given."""
    base = lanes if chunk is None else chunk
    return -(-base // quantum) * quantum


def _map(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` over every tensor of a lane tree: a tensor, a ``SimTables``
    (its ``device`` follows its tensors), a ``PolicyLanes``, ``None`` (kept),
    or a tuple, list or dict of them."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, SimTables):
        fields = {name: fn(getattr(tree, name)) for name in ARRAY_FIELDS
                  if getattr(tree, name) is not None}
        return dataclasses.replace(tree, device=fields["exec_us"].device,
                                   **fields)
    if isinstance(tree, PolicyLanes):
        return PolicyLanes(*(fn(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    raise TypeError(f"not a lane tree: {type(tree).__name__}")


def pad_lane_axis(tree, lanes: int, width: int, axis: int = 0):
    """Pad every tensor's lane ``axis`` from ``lanes`` up to ``width`` by
    repeating lane 0 — pad lanes are real, independent simulations whose
    outputs are dropped, so padding is inert by construction."""
    if lanes == width:
        return tree

    def _pad(x):
        zeros = torch.zeros(width - lanes, dtype=torch.long, device=x.device)
        return torch.cat([x, x.index_select(axis, zeros)], dim=axis)

    return _map(tree, _pad)


def host_tables(tables: SimTables, device: torch.device) -> SimTables:
    """``tables`` on the host, the form the streamer slices from (pinned for
    a CUDA ``device``); a set already on the CPU passes as it is."""
    if tables.device.type == "cpu":
        return tables
    return _map(tables, lambda x: host_tensor(x, device))


def _to_device(tree, device: torch.device):
    """A lane tree on ``device`` (asynchronous from pinned memory, on the
    current stream; a tensor already there passes as it is)."""
    return _map(tree, lambda x: x.to(device, non_blocking=True))


@contextlib.contextmanager
def _on_shard(device: torch.device, stream):
    """Run on ``device`` (its CUDA context current) and, where ``stream`` is
    given, on that stream once it has waited for the device's current one
    (so it sees every input made there)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield


def _record(tree, stream) -> None:
    """Mark the CUDA tensors of ``tree`` as used on ``stream``: the caching
    allocator then reuses none of them until that stream's work is done."""
    def mark(x):
        if x.is_cuda:
            x.record_stream(stream)
        return x

    if stream is not None:
        _map(tree, mark)


def _stream(lane_tree, lanes: int, chunk: Optional[int], mesh,
            launch: Callable, device: torch.device, shared=None) -> List[Dict]:
    """Stream ``lane_tree`` (host tensors, lane axis leading) in
    fixed-width chunks, each split into one block a lane-mesh device
    (``device`` alone when ``mesh`` is None), through ``launch(block,
    block_device, inputs)``: ``block`` on the host, ``inputs`` the tree
    ``shared`` on the block's device.  Every block of a chunk is launched
    (on its own stream of a CUDA device, when sharded) before any output is
    copied back; returns the blocks' output dicts on the host in lane order,
    pad lanes still attached (callers slice after concatenating)."""
    quantum = lane_count(mesh)
    devices = (device,) if mesh is None else mesh.devices
    width = padded_width(lanes, chunk, quantum)
    per = width // quantum
    shard_devices.reset()
    shard_devices.inc(quantum)
    # one stream a block on a CUDA card (the pool's: distinct up to 32 a
    # device); the unsharded path stays on the current stream
    streams = [torch.cuda.Stream(device=d)
               if mesh is not None and d.type == "cuda" else None
               for d in devices]
    inputs = {}
    for d in devices:
        if d not in inputs:
            with _on_shard(d, None):
                inputs[d] = _to_device(shared, d)
    outs = []
    for lo in range(0, lanes, width):
        hi = min(lo + width, lanes)
        piece = _map(lane_tree, lambda x: x[lo:hi])
        if hi - lo < width:
            shard_pad_lanes.inc(width - (hi - lo))
            piece = pad_lane_axis(piece, hi - lo, width)
        sweep_chunks.inc()
        issued = []
        for i, (d, s) in enumerate(zip(devices, streams)):
            block = _map(piece, lambda x: x[i * per:(i + 1) * per])
            with _on_shard(d, s):
                _record(inputs[d], s)
                issued.append(launch(block, d, inputs[d]))
        for d, s, out in zip(devices, streams, issued):
            with _on_shard(d, s):          # the copy waits for s's work only
                outs.append({k: v.cpu() if isinstance(v, torch.Tensor) else v
                             for k, v in out.items()})
    return outs


def _concat_out(chunks: List[Dict], lanes: int, axis: int = 0) -> Dict:
    """Concatenate per-block output dicts (tensors, or the telemetry's
    object arrays) on the streamed axis and drop the pad lanes."""
    out = {}
    for k in chunks[0]:
        parts = [c[k] for c in chunks]
        if isinstance(parts[0], np.ndarray):
            out[k] = np.concatenate(parts, axis=axis).take(range(lanes),
                                                           axis=axis)
        else:
            out[k] = torch.cat(parts, dim=axis).narrow(axis, 0, lanes)
    return out


def run_static_grid(tables: SimTables, node_of_pe: torch.Tensor,
                    arrival: torch.Tensor, app_idx: torch.Tensor, *,
                    policy: str, bins: int, repeats: int,
                    chunk: Optional[int] = None, mesh=None,
                    fplans: Optional[torch.Tensor] = None,
                    telemetry: Optional[Callable] = None
                    ) -> Tuple[Dict, torch.Tensor]:
    """The sharded and chunked twin of ``sweep._sweep_grid``: (D, S) lanes
    with the design axis streamed over ``mesh`` (the device of ``arrival``
    alone when None); returns host outputs with exactly D designs, each
    equal to the unsharded grid's.

    ``fplans`` (F, P) switches to the fail-stop grid: outputs gain a leading
    (F,) fault-lane axis and the design axis (still the streamed one) moves
    to position 1 (DESIGN.md §14).  ``telemetry`` (the sweep's replay,
    ``(tables, out, gov, design_ids) -> object array``) adds the lanes'
    timelines under ``"telemetry"``, shaped like the grid."""
    from .sweep import _sweep_grid, _sweep_grid_faults  # sweep imports us
    dev = arrival.device
    lanes = int(tables.exec_us.shape[0])
    # each block carries its designs' indices (a pad lane repeats lane 0's)
    lane_tree = (host_tables(tables, dev), host_tensor(node_of_pe, dev),
                 torch.arange(lanes))

    def launch(block, d, inputs):
        tb, nodes, ids = _to_device(block, d)
        arr, app, fp = inputs
        if fp is not None:
            out, temps = _sweep_grid_faults(tb, nodes, fp, arr, app, policy,
                                            bins=bins, repeats=repeats)
        else:
            out, temps = _sweep_grid(tb, nodes, arr, app, policy, bins=bins,
                                     repeats=repeats)
        if telemetry is not None:
            out["telemetry"] = telemetry(tb, out, None, ids)
        return {**out, "_peak_temp_scan_c": temps}

    out = _concat_out(_stream(lane_tree, lanes, chunk, mesh, launch, dev,
                              (arrival, app_idx, fplans)),
                      lanes, axis=1 if fplans is not None else 0)
    return out, out.pop("_peak_temp_scan_c")


def run_dtpm_grid(tables: SimTables, gov: PolicyLanes, arrival: torch.Tensor,
                  app_idx: torch.Tensor, *, policy: str,
                  chunk: Optional[int] = None, mesh=None,
                  fplans: Optional[torch.Tensor] = None,
                  telemetry: Optional[Callable] = None) -> Dict:
    """The sharded and chunked twin of ``sweep._sweep_grid_dtpm``: (D, G, S)
    lanes, streaming whichever of the design (D) and policy (G) axes is
    wider over ``mesh`` — the ``PolicyLanes`` rows are as much a lane stack
    as the ``SimTables`` ones (DESIGN.md §10); the other axis goes whole into
    every block (policies stay on the host: K1's wrapper copies a launch's
    lanes).  ``fplans`` switches to the fail-stop grid: outputs gain a
    leading (F,) axis and the streamed axis shifts one position right
    (DESIGN.md §14).  ``telemetry`` as :func:`run_static_grid`'s."""
    from .sweep import _sweep_grid_dtpm, _sweep_grid_dtpm_faults
    dev = arrival.device
    D, G = int(tables.exec_us.shape[0]), gov.lanes
    faulted = fplans is not None

    def grid(tb, g, inputs):
        arr, app, fp = inputs
        if faulted:
            out = _sweep_grid_dtpm_faults(tb, g, fp, arr, app, policy)
        else:
            out = _sweep_grid_dtpm(tb, g, arr, app, policy)
        if telemetry is not None:
            out["telemetry"] = telemetry(tb, out, g, None)
        return out

    shared = (arrival, app_idx, fplans)
    if D >= G:                               # stream designs, reuse policies
        out = _stream(host_tables(tables, dev), D, chunk, mesh,
                      lambda tb, d, inputs: grid(_to_device(tb, d), gov,
                                                 inputs),
                      dev, shared)
        return _concat_out(out, D, axis=1 if faulted else 0)
    # stream policies: the whole table stack is an input of every block,
    # each block under a table object of its own, so that K1's per-table
    # preparation (``epoch_scan._prepare``) is made on the block's stream
    out = _stream(gov, G, chunk, mesh,
                  lambda g, d, inputs: grid(dataclasses.replace(inputs[1]), g,
                                            inputs[0]),
                  dev, (shared, tables))
    return _concat_out(out, G, axis=2 if faulted else 1)


def resolve_mesh(shard: Optional[bool],
                 devices: Optional[Sequence[torch.device]] = None):
    """The lane mesh a sweep should use: ``shard=None`` auto-shards when
    there is more than one lane device (``sharding.lane_devices``: the
    process's CUDA cards, or N virtual ones), ``False`` never shards,
    ``True`` asks for the mesh explicitly (still ``None`` — unsharded — when
    only one lane device exists; the chunked path works either way)."""
    if shard is False:
        return None
    return lane_mesh(devices)
