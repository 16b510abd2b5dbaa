"""Stack per-design simulation tables into one (D, …) table set, on PyTorch.

The twin of ``src/repro/dse/batch.py``.  Designs differ in PE count, so every
design's tables are padded to the fleet-wide maximum and stacked into one
``SimTables`` whose array fields carry a leading design axis: built as
stacks in one pass over the designs (``build_table_stack``), or stacked
field by field from per-design tables (:func:`stack_tables`).
Padding is inert by construction (1e30 latency, zero power, the accel node;
DESIGN.md §5), so the scan needs no masking logic: where the reference
vmaps over the design axis × the trace axis, K1 runs designs × [fault plans
×] [policies ×] traces as ONE launch of design-major lanes — lane l reads
design l // (its lanes per design) — and the CPU runs K1's plain version on
the same lanes.

The lane order is the one thing to get right: the reference nests its lanes
(F fault plans, D designs, G policies, S traces), fault plans outermost;
K1 reads the design as ``lane / S``, so the grid goes to the kernel as
(D, F, G, S) (:func:`to_design_major`) and comes back through
:func:`from_design_major`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.applications import Application
from ..core.dvfs import Governor, PolicyLanes
from ..core.jobgen import JobTrace
from ..core.simkernel_torch import (ARRAY_FIELDS, SimTables,
                                    build_table_stack, simulate_batch,
                                    simulate_batch_dtpm, tables_from_numpy)
from ..obs import metrics as _metrics
from .space import DesignPoint


@dataclasses.dataclass(frozen=True, eq=False)
class DesignBatch:
    """D stacked designs ready for batched simulation.

    No per-PE mask is stored: padding is inert inside the kernel (DESIGN.md
    §5), and consumers slice per-design outputs with ``points[d].num_pes``.
    """
    points: Tuple[DesignPoint, ...]
    tables: SimTables                 # array fields carry a leading (D, …) axis
    # (D, P) i32 thermal node per PE slot: ``tables.node_of_pe``, kept as
    # the reference's field (the grid path reads the tables')
    node_of_pe: torch.Tensor

    @property
    def num_designs(self) -> int:
        return len(self.points)

    @property
    def dynamic(self) -> bool:
        """True when the tables carry OPP ladders for dynamic DTPM policies."""
        return self.tables.exec_opp is not None


def stack_tables(tables: Sequence[SimTables], host: bool = False,
                 device=None) -> SimTables:
    """Field-by-field stack of identically-shaped SimTables into (D, …)
    tensors on ``device`` (default: the first table set's).  ``t_max`` and
    ``num_pes`` are the padded ones.

    ``host=True`` keeps the stacks on the CPU — the form the chunked lane
    executor (``scenario.shardexec``) streams from, so a grid is never
    device-resident at once — pinned when ``device`` is a CUDA device (the
    chunks then copy to it asynchronously), plain CPU tensors otherwise."""
    shapes = {(t.t_max, t.num_pes) for t in tables}
    if len(shapes) != 1:
        raise ValueError(f"tables must be padded to one shape, got {shapes}")
    if len({t.exec_opp is None for t in tables}) != 1:
        raise ValueError("tables mix static and dynamic (OPP-ladder) sets")
    first = tables[0]
    dev = first.device if device is None else resolve_device(device)
    fields = {name: torch.stack([getattr(t, name) for t in tables])
              for name in ARRAY_FIELDS if getattr(first, name) is not None}
    if host:
        return SimTables(t_max=first.t_max, num_pes=first.num_pes,
                         device=torch.device("cpu"),
                         **{k: host_tensor(v, dev) for k, v in fields.items()})
    return SimTables(t_max=first.t_max, num_pes=first.num_pes, device=dev,
                     **{k: v.to(dev) for k, v in fields.items()})


def host_tensor(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on the CPU, pinned when it is to stream to a CUDA ``device``."""
    x = x.cpu()
    return x.pin_memory() if torch.device(device).type == "cuda" else x


@_metrics.spanned(_metrics.ENTRY)
@_metrics.spanned(_metrics.TABLES)
def build_design_batch(points: Sequence[DesignPoint],
                       apps: Sequence[Application],
                       pad_pes: Optional[int] = None,
                       governor: Optional[Governor] = None,
                       device="cuda") -> DesignBatch:
    """Build + pad + stack the simulation tables for a list of designs.

    By default every design bakes its own frequency-cap (userspace) governor
    — the static-DVFS slice of the space.  Passing a *dynamic* ``governor``
    (the ondemand family) instead builds the OPP-indexed tables the DTPM
    scan gathers from, with each design's OPP ladder truncated at its
    per-cluster frequency caps.  The tables are built on the host as (D, …)
    stacks in one array build over the designs
    (``core.simkernel_torch.build_table_stack``) and moved to ``device``
    once.
    """
    if not points:
        raise ValueError("empty design list")
    # one database a SoC: designs that differ in their clocks alone share it
    socs = {p.soc_key(): p for p in points}
    socs = {k: p.to_db() for k, p in socs.items()}
    dbs = [socs[p.soc_key()] for p in points]
    P = max(db.num_pes for db in dbs)
    if pad_pes is not None:
        if pad_pes < P:
            raise ValueError(f"pad_pes={pad_pes} < widest design {P}")
        P = pad_pes
    if governor is not None:
        if not governor.policy().dynamic:
            # a uniform static governor would silently override the
            # per-design frequency caps the sweep contract assumes
            raise ValueError(
                "build_design_batch bakes per-design frequency caps; pass "
                "a dynamic (ondemand-family) governor to add OPP ladders, "
                "or None for the static design-cap tables")
        governors = [governor] * len(points)
        caps = [p.freq_caps() for p in points]
    else:
        governors, caps = [p.governor() for p in points], None
    fields, T, P = build_table_stack(dbs, apps, governors, pad_pes=P,
                                     freq_caps=caps)
    tables = tables_from_numpy(fields, T, P, device)
    return DesignBatch(points=tuple(points), tables=tables,
                       node_of_pe=tables.node_of_pe)


def stack_traces(traces: Sequence[JobTrace],
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, J) arrival f32 / app-index int32 tensors from S equal-length job
    traces."""
    lens = {t.num_jobs for t in traces}
    if len(lens) != 1:
        raise ValueError(f"traces must have equal job counts, got {lens}")
    dev = resolve_device(device)
    arr = torch.from_numpy(np.stack([t.arrival_us for t in traces])
                           .astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.stack([t.app_index for t in traces])
                           .astype(np.int32)).to(dev)
    return arr, idx


def to_design_major(x: torch.Tensor) -> torch.Tensor:
    """(F, D, G, S, ...) -> (D*F*G*S, ...): the reference's lane nest (fault
    plans outermost) as K1's design-major lanes, lane l on design
    l // (F*G*S)."""
    F, D, G, S = x.shape[:4]
    return x.movedim(1, 0).reshape(D * F * G * S, *x.shape[4:])


def from_design_major(x: torch.Tensor, F: int, D: int, G: int,
                      S: int) -> torch.Tensor:
    """The inverse of :func:`to_design_major`: (D*F*G*S, ...) ->
    (F, D, G, S, ...)."""
    return x.reshape(D, F, G, S, *x.shape[1:]).movedim(0, 1)


def grid_lanes(tables: SimTables, arrival: torch.Tensor,
               app_idx: torch.Tensor, gov: Optional[PolicyLanes] = None,
               fplans: Optional[torch.Tensor] = None):
    """K1's lanes of an [F fault plans ×] D designs × [G policies ×] S traces
    grid, design-major on the tables' device: (arrival, app_idx) (L, J),
    the L lanes' policies (``None`` without ``gov``), their (L, P) fail
    times (``None`` without ``fplans``), and the grid's (F, D, G, S), absent
    axes counted 1."""
    D = int(tables.exec_us.shape[0])
    S, J = arrival.shape
    F = 1 if fplans is None else int(fplans.shape[0])
    G = 1 if gov is None else gov.lanes
    dev = tables.device
    arrival = arrival.to(dev, torch.float32)
    app_idx = app_idx.to(dev, torch.int32)
    lanes_arr = to_design_major(arrival.expand(F, D, G, S, J))
    lanes_app = to_design_major(app_idx.expand(F, D, G, S, J))
    plans = pols = None
    if fplans is not None:
        fplans = torch.as_tensor(fplans, dtype=torch.float32).to(dev)
        plans = to_design_major(fplans[:, None, None, None, :].expand(
            F, D, G, S, fplans.shape[1]))
    if gov is not None:
        g = torch.arange(G)[None, None, :, None].expand(F, D, G, S)
        pols = gov.take(to_design_major(g))
    return lanes_arr, lanes_app, pols, plans, (F, D, G, S)


def simulate_grid(tables: SimTables, policy: str, arrival: torch.Tensor,
                  app_idx: torch.Tensor, gov: Optional[PolicyLanes] = None,
                  fplans: Optional[torch.Tensor] = None) -> Dict:
    """[F fault plans ×] D designs × [G policies ×] S traces in ONE epoch
    scan (one K1 launch on a CUDA device), then the epilogue.

    ``tables``: D stacked designs; ``arrival`` / ``app_idx`` (S, J), shared
    by every design; ``gov``: (G,) ``PolicyLanes`` (``core.dvfs.
    stack_policies``), the closed-loop DTPM program; ``fplans``: (F, P) fail
    times (``scenario.faults.stack_fault_plans``), the fail-stop program.
    Every output gains leading ([F,] D, [G,] S) axes over ``simulate_torch``'s
    — the reference's ``_simulate_grid`` / ``_simulate_grid_faults`` and the
    vmaps of its DTPM grids.
    """
    lanes_arr, lanes_app, pols, plans, (F, D, G, S) = grid_lanes(
        tables, arrival, app_idx, gov, fplans)
    if gov is None:
        out = simulate_batch(tables, policy, lanes_arr, lanes_app, plans)
    else:
        out = simulate_batch_dtpm(tables, policy, lanes_arr, lanes_app, pols,
                                  plans)
    grid = {}
    for key, v in out.items():
        v = from_design_major(v, F, D, G, S)
        if gov is None:
            v = v[:, :, 0]
        grid[key] = v if fplans is not None else v[0]
    return grid


def simulate_design_batch(batch: DesignBatch, policy: str,
                          arrival, app_idx) -> Dict:
    """Run all designs × traces in one epoch scan.

    ``arrival``/``app_idx``: (S, J) as from :func:`stack_traces`.  Every entry
    of the returned dict gains leading (D, S) axes over ``simulate_torch``'s
    output — e.g. ``avg_job_latency_us`` is (D, S), ``busy_per_pe_us`` is
    (D, S, P).
    """
    arrival = torch.as_tensor(arrival, dtype=torch.float32)
    app_idx = torch.as_tensor(app_idx, dtype=torch.int32)
    if arrival.ndim != 2:
        raise ValueError("arrival must be (num_traces, num_jobs)")
    return simulate_grid(batch.tables, policy, arrival, app_idx)
