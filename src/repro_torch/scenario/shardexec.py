"""The grid program and its lane executor, the one route from ``sweep`` to
K1, the epilogue and the thermal grid, on PyTorch (DESIGN.md §13).

The twin of ``src/repro/scenario/shardexec.py``.  :func:`grid_program` is
one grid scan (one K1 launch, its epilogue, and K6 on a static grid);
:func:`run_grid` runs it over a sweep's grid and brings back the outputs
the sweep reads (:data:`KEPT_KEYS`), the schedules left on the device.
Without ``chunk`` and a mesh that is one launch on the current stream.  A
grid is embarrassingly parallel along its *lane* axis: the stacked design
axis of ``SimTables`` (static and fault sweeps) or, when the policy grid
is the wide one, the stacked :class:`~repro_torch.core.dvfs.PolicyLanes`
axis (dynamic DTPM sweeps).  :func:`run_grid` scales that axis two ways,
composably:

* **lane sharding** — over a 1-D lane mesh (``repro_torch.sharding.
  lane_mesh``), each chunk of ``width`` lanes splits into one contiguous
  block of ``width / devices`` lanes a mesh device.  Every block is copied to
  its device and launched there on a stream of its own, all blocks of a
  chunk before any output comes back; the outputs are then copied to the
  host in lane order.  The mesh's devices are the process's CUDA cards, or
  one device N times under ``sharding.virtual_lane_devices(N)`` (N blocks
  on N streams of one card, or one after another on the CPU).  Lanes are
  independent, so every output equals the unsharded sweep's bit for bit.
* **chunked streaming** — ``sweep(..., chunk=N)`` streams the lane axis
  through the same grid program in fixed-width chunks: the lane stacks stay
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

Telemetry (``sweep(..., telemetry=True)``): each launch's lanes are
replayed on its device and stream right after it, before its outputs go back
(``telemetry``, the sweep's replay callable), so the timelines equal the
unsharded sweep's bit for bit: a lane's replay reads only that lane.

Observability: ``scenario.shard.devices`` (lane-mesh width of the most
recent streamed grid), ``scenario.shard.pad_lanes`` (pad lanes added) and
``scenario.sweep.chunks`` (chunks streamed, not blocks) in the
``obs.metrics`` registry; ``obs.metrics.scan_calls`` (grid scans run).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dvfs import PolicyLanes
from ..core.simkernel_torch import ARRAY_FIELDS, SimTables
from ..dse.batch import host_tensor, simulate_grid
from ..dse.thermal_torch import peak_temperature_grid
from ..obs import metrics as _metrics
from ..sharding import lane_count, lane_mesh

# lane-mesh width of the most recent streamed grid (1 = unsharded)
shard_devices = _metrics.counter("scenario.shard.devices")
# cumulative pad lanes added for chunk/device-count divisibility
shard_pad_lanes = _metrics.counter("scenario.shard.pad_lanes")
# cumulative fixed-width chunks streamed through the grid program
sweep_chunks = _metrics.counter("scenario.sweep.chunks")

# the grid outputs a sweep reads, the only ones copied back to the host
KEPT_KEYS = ("avg_job_latency_us", "makespan_us", "energy_j",
             "busy_per_pe_us", "peak_temp_c", "telemetry")


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
    copied back; returns the blocks' :func:`_fetch` dicts in lane order,
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
                _metrics.wait(d, s)
                outs.append(_fetch(out))
    return outs


def _concat_out(chunks: List[Dict], lanes: int, axis: int = 0) -> Dict:
    """Concatenate per-block host outputs on the streamed axis and drop the
    pad lanes."""
    return {k: np.concatenate([c[k] for c in chunks], axis=axis).take(
        range(lanes), axis=axis) for k in chunks[0]}


def grid_program(tables: SimTables, arrival: torch.Tensor,
                 app_idx: torch.Tensor, *, policy: str,
                 gov: Optional[PolicyLanes] = None,
                 fplans: Optional[torch.Tensor] = None, bins: int,
                 repeats: int) -> Dict:
    """One grid scan: ONE K1 launch and its epilogue over [F fault plans ×]
    D designs × [G policies ×] S traces (``dse.batch.simulate_grid``), with
    ``peak_temp_c`` in its outputs.  A static grid (``gov`` None) takes it
    from the thermal grid (K6: ``bins``, ``repeats``, the node map and the
    powers of ``tables``); a DTPM grid from K1's inline RC loop, the one its
    throttle feedback integrates.  Counts ``scan_calls[DTPM, FAULTS]``."""
    _metrics.scan_calls[gov is not None, fplans is not None] += 1
    out = simulate_grid(tables, policy, arrival, app_idx, gov=gov,
                        fplans=fplans)
    if gov is None:
        out["peak_temp_c"] = peak_temperature_grid(
            out, tables.node_of_pe, tables.power_active, tables.power_idle,
            bins=bins, repeats=repeats)
    return out


def _fetch(out: Dict) -> Dict:
    """The outputs a sweep reads, on the host: the sums in float64 (widened
    on the device, as the sweep has always read them) and the telemetry's
    object array; the schedules stay behind."""
    return {k: v if isinstance(v, np.ndarray) else v.double().cpu().numpy()
            for k, v in out.items() if k in KEPT_KEYS}


def run_grid(tables: SimTables, arrival: torch.Tensor, app_idx: torch.Tensor,
             *, policy: str, gov: Optional[PolicyLanes] = None,
             fplans: Optional[torch.Tensor] = None, bins: int, repeats: int,
             chunk: Optional[int] = None, mesh=None,
             telemetry: Optional[Callable] = None) -> Dict:
    """:func:`grid_program` over the grid's lanes, its :data:`KEPT_KEYS` on
    the host as float64 arrays shaped ([F,] D, [G,] S, ...).

    Without ``chunk`` and ``mesh`` it is one launch on the current stream
    over the inputs where they are.  Otherwise the lanes stream over
    ``mesh`` (the device of ``arrival`` alone when None) in ``chunk``-wide
    chunks: the designs of a static grid; of a DTPM grid whichever of the
    designs (D) and policies (G) is wider — the ``PolicyLanes`` rows are as
    much a lane stack as the ``SimTables`` ones (DESIGN.md §10) — the other
    axis going whole into every block (policies stay on the host: K1's
    wrapper copies a launch's lanes).  Every output equals the unstreamed
    grid's bit for bit.  ``fplans`` (F, P) adds the leading fault-lane axis
    (DESIGN.md §14).  ``telemetry`` (the sweep's replay, ``(tables, out,
    gov, design_ids) -> object array``) adds each launch's timelines under
    ``"telemetry"``, shaped like the grid; ``design_ids`` index the
    launch's designs into the grid's."""
    dev = arrival.device
    D = int(tables.exec_us.shape[0])

    def launch(tb, g, ids, inputs):
        arr, app, fp = inputs
        out = grid_program(tb, arr, app, policy=policy, gov=g, fplans=fp,
                           bins=bins, repeats=repeats)
        if telemetry is not None:
            out["telemetry"] = telemetry(tb, out, g, ids)
        return out

    shared = (arrival, app_idx, fplans)
    if chunk is None and mesh is None:
        out = launch(tables, gov, torch.arange(D), shared)
        _metrics.wait(dev)
        return _fetch(out)
    axis = int(fplans is not None)
    if gov is None or D >= gov.lanes:        # stream designs, reuse policies
        # each block carries its designs' indices (a pad lane repeats
        # lane 0's)
        blocks = _stream(
            (host_tables(tables, dev), torch.arange(D)), D, chunk, mesh,
            lambda b, d, inputs: launch(_to_device(b[0], d), gov, b[1],
                                        inputs), dev, shared)
        return _concat_out(blocks, D, axis)
    # stream policies: the whole table stack is an input of every block,
    # each block under a table object of its own, so that K1's per-table
    # preparation (``epoch_scan._prepare``) is made on the block's stream
    blocks = _stream(
        gov, gov.lanes, chunk, mesh,
        lambda g, d, inputs: launch(dataclasses.replace(inputs[1]), g,
                                    torch.arange(D), inputs[0]),
        dev, (shared, tables))
    return _concat_out(blocks, gov.lanes, axis + 1)


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
