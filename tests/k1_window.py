"""The most jobs K1 (``csrc/epoch_scan.cuh``) holds in a lane, worked out on
the host from the plain scan's outputs: the oracle of the kernel's per-lane
``live`` output, shared by the CPU model of its bookkeeping
(tests/test_torch_k1_incremental.py), its card tests
(tests/test_torch_epoch_scan_long_card.py) and the registry counters' tests
(tests/test_torch_k1_live.py).

Imports torch and the port only, so that it runs on the card's machine too.
"""
import math

import torch

from repro_torch.kernels import epoch_scan as k1


def live_jobs(tables, arrival: torch.Tensor, app_idx: torch.Tensor,
              scheduled: torch.Tensor, finish: torch.Tensor,
              faults: bool = False) -> torch.Tensor:
    """(L,) int32: the most jobs K1's window held in each lane, from the
    scan's ``scheduled`` and ``finish``.  Every pick is the least (ready,
    flat index) left and a ready time is never below the pick that made it,
    so the picks run in the order of the committed cells' final keys, and
    jobs take their first pick in order.  The window takes jobs a chunk of
    32 at a time: chunk 0 first, chunk c once job 32c - 1 has its first
    pick; it then runs from the first job with a cell left to the chunk's
    last job.  Each job is taken to have a task; the fail-stop programs keep
    every job live (J)."""
    L, J = arrival.shape
    dev = arrival.device
    if faults:
        return torch.full((L,), J, dtype=torch.int32, device=dev)
    T = scheduled.shape[-1]
    design = k1.lane_designs(tables, L, app_idx.device)[:, None]
    app = app_idx.long()
    valid = k1.per_design(tables, "valid")[design, app]             # (L, J, T)
    pred = k1.per_design(tables, "pred")                            # (D, A, T, T)
    ready = arrival.float()[:, :, None].expand(L, J, T)
    for q in range(T):
        ready = torch.where(pred[design, app, :, q], torch.maximum(
            ready, finish[:, :, q:q + 1]), ready)
    committed = (scheduled & valid).flatten(1)                      # (L, J*T)
    order = torch.sort(torch.where(committed, ready.flatten(1), math.inf),
                       dim=1, stable=True).indices
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(J * T, device=dev).expand(L, -1)).view(L, J, T)
    taken = committed.view(L, J, T)
    first = torch.where(taken, pos, J * T).amin(2)                  # (L, J)
    last = torch.where(taken, pos, -1).amax(2).cummax(1).values
    chunk = torch.arange(-(-J // 32), device=dev)
    # the pick after which each chunk comes in, and the window's first job then
    at = torch.where(chunk > 0, first[:, (32 * chunk - 1).clamp(min=0)] + 1, 0)
    lo = torch.searchsorted(last.contiguous(), at.contiguous())
    held = (32 * chunk + 31).clamp(max=J - 1) - lo + 1
    return held.amax(1).to(torch.int32)


def kernel_live(tables, arrival, app_idx, scheduled, finish,
                faults: bool = False, dtpm: bool = False) -> torch.Tensor:
    """(L,) int32: K1's ``live`` output: J where a lane takes every job at
    the start (the fail-stop programs, and the static one where the ring
    has a slot for each job), else :func:`live_jobs`."""
    L, J = arrival.shape
    if faults or (not dtpm and J <= k1.RING):
        return torch.full((L,), J, dtype=torch.int32, device=arrival.device)
    return live_jobs(tables, arrival, app_idx, scheduled, finish)
