"""Chunked lane execution for sweep grids, on PyTorch (DESIGN.md §13).

The twin of ``src/repro/scenario/shardexec.py``.  A sweep's grid is
embarrassingly parallel along its *lane* axis: the stacked design axis of
``SimTables`` (static and fault sweeps) or, when the policy grid is the wide
one, the stacked :class:`~repro_torch.core.dvfs.PolicyLanes` axis (dynamic
DTPM sweeps).  ``sweep(..., chunk=N)`` streams that axis through the same
grid programs in fixed-width chunks: the lane stacks stay on the host
(pinned for a CUDA device, ``dse.batch.stack_tables(host=True)``), each
chunk is copied to the device, run as one ``simulate_grid`` (one K1 launch)
plus its epilogue and thermal grid, and its outputs come back to the host
before the next chunk goes in — so the device holds one chunk's tables,
K1 scratch and outputs at a time, not the grid's.

Chunk widths are pinned: the last chunk is padded up to the width by
repeating its lane 0, so every chunk's K1 launch has the same lane count and
scratch size.  Unlike ``dse.batch``'s in-kernel inert padding (1e30
latency, zero power), pad lanes here are ordinary simulations whose outputs
are sliced off — inert because lanes never interact.  Inside a chunk the
lanes stay design-major (``dse.batch.to_design_major``), so K1 reads a
lane's design as it does unchunked and every lane equals its unchunked self
bit for bit on the schedule.

A chunk counts what the reference's does: N designs for static and fault
sweeps, N of the wider of designs and policies for DTPM ones.

Lane sharding over several devices is not ported: the port runs on one
card, where the reference's lane mesh is ``None`` too (``resolve_mesh``).

Observability: ``scenario.shard.devices`` (devices of the most recent
streamed grid, 1), ``scenario.shard.pad_lanes`` (pad lanes added) and
``scenario.sweep.chunks`` (chunks streamed) in the ``obs.metrics`` registry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.dvfs import PolicyLanes
from ..core.simkernel_torch import ARRAY_FIELDS, SimTables
from ..dse.batch import host_tensor
from ..obs import metrics as _metrics

# devices of the most recent streamed grid (always 1: one card)
shard_devices = _metrics.counter("scenario.shard.devices")
# cumulative pad lanes added to fill the last chunk to the pinned width
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
    (its ``device`` follows its tensors), a ``PolicyLanes``, or a tuple,
    list or dict of them."""
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
    """A chunk's lane tree on ``device`` (asynchronous from pinned memory)."""
    return _map(tree, lambda x: x.to(device, non_blocking=True))


def _stream(lane_tree, lanes: int, chunk: Optional[int],
            launch: Callable) -> List[Dict]:
    """Stream ``lane_tree`` (host tensors, lane axis leading) through
    ``launch(host_chunk)`` in fixed-width chunks; returns the per-chunk
    output dicts on the host, pad lanes still attached (callers slice after
    concatenating)."""
    quantum = 1                               # one device (resolve_mesh)
    width = padded_width(lanes, chunk, quantum)
    shard_devices.reset()
    shard_devices.inc(quantum)
    outs = []
    for lo in range(0, lanes, width):
        hi = min(lo + width, lanes)
        piece = _map(lane_tree, lambda x: x[lo:hi])
        if hi - lo < width:
            shard_pad_lanes.inc(width - (hi - lo))
            piece = pad_lane_axis(piece, hi - lo, width)
        sweep_chunks.inc()
        outs.append({k: v.cpu() for k, v in launch(piece).items()})
    return outs


def _concat_out(chunks: List[Dict], lanes: int, axis: int = 0) -> Dict:
    """Concatenate per-chunk output dicts on the streamed axis and drop the
    pad lanes."""
    return {k: torch.cat([c[k] for c in chunks], dim=axis).narrow(axis, 0,
                                                                  lanes)
            for k in chunks[0]}


def run_static_grid(tables: SimTables, node_of_pe: torch.Tensor,
                    arrival: torch.Tensor, app_idx: torch.Tensor, *,
                    policy: str, bins: int, repeats: int,
                    chunk: Optional[int] = None,
                    fplans: Optional[torch.Tensor] = None
                    ) -> Tuple[Dict, torch.Tensor]:
    """The chunked twin of ``sweep._sweep_grid``: (D, S) lanes with the
    design axis streamed, on the device of ``arrival``; returns host
    outputs with exactly D designs, each equal to the unchunked grid's.

    ``fplans`` (F, P) switches to the fail-stop grid: outputs gain a leading
    (F,) fault-lane axis and the design axis (still the streamed one) moves
    to position 1 (DESIGN.md §14)."""
    from .sweep import _sweep_grid, _sweep_grid_faults  # sweep imports us
    dev = arrival.device
    lanes = int(tables.exec_us.shape[0])
    lane_tree = (host_tables(tables, dev), host_tensor(node_of_pe, dev))

    def launch(piece):
        tb, nodes = _to_device(piece, dev)
        if fplans is not None:
            out, temps = _sweep_grid_faults(tb, nodes, fplans, arrival,
                                            app_idx, policy, bins=bins,
                                            repeats=repeats)
        else:
            out, temps = _sweep_grid(tb, nodes, arrival, app_idx, policy,
                                     bins=bins, repeats=repeats)
        return {**out, "_peak_temp_scan_c": temps}

    out = _concat_out(_stream(lane_tree, lanes, chunk, launch), lanes,
                      axis=1 if fplans is not None else 0)
    return out, out.pop("_peak_temp_scan_c")


def run_dtpm_grid(tables: SimTables, gov: PolicyLanes, arrival: torch.Tensor,
                  app_idx: torch.Tensor, *, policy: str,
                  chunk: Optional[int] = None,
                  fplans: Optional[torch.Tensor] = None) -> Dict:
    """The chunked twin of ``sweep._sweep_grid_dtpm``: (D, G, S) lanes,
    streaming whichever of the design (D) and policy (G) axes is wider —
    the ``PolicyLanes`` rows are as much a lane stack as the ``SimTables``
    ones (DESIGN.md §10); the other axis goes whole into every chunk.
    ``fplans`` switches to the fail-stop grid: outputs gain a leading (F,)
    axis and the streamed axis shifts one position right (DESIGN.md §14)."""
    from .sweep import _sweep_grid_dtpm, _sweep_grid_dtpm_faults
    dev = arrival.device
    D, G = int(tables.exec_us.shape[0]), gov.lanes
    faulted = fplans is not None

    def grid(tb, g):
        if faulted:
            return _sweep_grid_dtpm_faults(tb, g, fplans, arrival, app_idx,
                                           policy)
        return _sweep_grid_dtpm(tb, g, arrival, app_idx, policy)

    if D >= G:                               # stream designs, reuse policies
        out = _stream(host_tables(tables, dev), D, chunk,
                      lambda tb: grid(_to_device(tb, dev), gov))
        return _concat_out(out, D, axis=1 if faulted else 0)
    tables_dev = _to_device(tables, dev)       # policies stay on the host
    out = _stream(gov, G, chunk, lambda g: grid(tables_dev, g))
    return _concat_out(out, G, axis=2 if faulted else 1)


def resolve_mesh(shard: Optional[bool]):
    """The lane mesh a sweep should use: always ``None``, the unsharded
    path on the one device the sweep runs on.  ``shard=None`` (auto),
    ``False`` and ``True`` all resolve to it, as the reference's
    ``resolve_mesh`` does on one device (``repro.sharding.lane_mesh``
    returns ``None`` there); the chunked path works either way.  Lane
    sharding over several cards is not ported (ROADMAP.md)."""
    return None
