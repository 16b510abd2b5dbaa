"""K7: the epilogue of an epoch scan — latency, energy and per-PE busy time
of (L, J, T) schedules — as one CUDA kernel.

No Pallas original: the reference computes these sums with XLA arithmetic
after its scan (``src/repro/core/simkernel_jax.py:533-571``).  On CUDA
tensors :func:`epilogue` is one launch of ``csrc/epilogue.cu`` (a block of
three warps a lane; design notes at its top), on CPU tensors :func:`epilogue_plain`, the
eager version.  Both sum in :func:`~.epoch_scan.tree_sum`'s fixed order, so
the kernel's outputs equal the plain version's bit for bit and a lane gets
the same bits in any call.  Every launch adds one to the registry counter
``epilogue_launches`` (``obs.metrics``), which ``run_manifest`` reports.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from ..obs import metrics as _metrics
from .epoch_scan import lane_designs, lanes_per_design, per_design, tree_sum

LAUNCHES = "epilogue_launches"


def epilogue_plain(tables, arrival: torch.Tensor, app_idx: torch.Tensor,
                   scheduled, start, finish, onpe,
                   onopp=None) -> Dict[str, torch.Tensor]:
    """:func:`epilogue` in eager tensor code, the path of CPU tensors and the
    kernel's oracle: the reference's post-scan arithmetic, lanes first, every
    sum a :func:`tree_sum` over the lane's own (J·T) cells, jobs or PEs."""
    L = app_idx.shape[0]
    design = lane_designs(tables, L, app_idx.device)                    # (L,)
    valid_j = per_design(tables, "valid")[design[:, None], app_idx.long()]  # (L, J, T)
    busy = torch.where(valid_j, finish - start, 0.0)
    fin_valid = torch.where(valid_j, finish, 0.0)
    makespan = fin_valid.amax(dim=(1, 2))                               # (L,)
    job_finish = fin_valid.amax(dim=2)                                  # (L, J)
    avg_latency = tree_sum(job_finish - arrival) / job_finish.shape[1]
    # energy: active while busy + idle leakage elsewhere  (uJ = W * us).
    # busy · power of its PE is the reference's busy · onehot · power (the
    # one-hot factor is exactly 1 or 0); per-PE sums one PE at a time keep
    # memory at (L, J·T) without an (L, J·T, P) one-hot
    cell_pe = onpe.long().flatten(1)                                    # (L, J*T)
    if onopp is None:
        p_task = per_design(tables, "power_active")[design].gather(1, cell_pe)
    else:
        K = tables.power_active_opp.shape[-1]
        p_task = per_design(tables, "power_active_opp")[design].flatten(1) \
            .gather(1, cell_pe * K + onopp.long().flatten(1))
    busy_cells = busy.flatten(1)                                        # (L, J*T)
    e_active = tree_sum(busy_cells * p_task)
    busy_per_pe = torch.stack([tree_sum(torch.where(cell_pe == pe, busy_cells, 0.0))
                               for pe in range(tables.num_pes)], dim=1)  # (L, P)
    e_idle = tree_sum(per_design(tables, "power_idle")[design]
                      * torch.clamp(makespan[:, None] - busy_per_pe, min=0.0))
    energy_j = (e_active + e_idle) * 1e-6                               # W·us -> J
    return dict(finish=finish, start=start, onpe=onpe, scheduled=scheduled,
                job_finish=job_finish, makespan_us=makespan,
                avg_job_latency_us=avg_latency, energy_j=energy_j,
                busy_per_pe_us=busy_per_pe)


# K7 (csrc/epilogue.cu), loaded at its first launch; its C entry checks the
# shapes and the shared memory they need
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("epilogue")
        fn = lib.repro_epilogue
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        spill = lib.repro_epilogue_spill
        spill.restype = ctypes.c_longlong
        spill.argtypes = [ctypes.c_int] * 6
        info = lib.repro_epilogue_info
        info.restype = ctypes.c_int
        info.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        err = lib.repro_epilogue_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = {"launch": fn, "info": info, "error": err, "spill": spill}
    return _fn


def _raise_on(rc: int, what: str) -> None:
    """The C entry's return code as an exception: ValueError for the
    arguments it refuses (negative codes), RuntimeError for CUDA's."""
    if rc != 0:
        msg = f"epilogue: {_kernel()['error'](rc).decode()} ({what})"
        raise ValueError(msg) if rc < 0 else RuntimeError(msg)


def kernel_info(J: int, T: int, A: int, P: int, K: Optional[int] = None,
                device=None) -> dict:
    """Threads a block, dynamic shared bytes, resident blocks an SM,
    registers a thread, local bytes a thread and slots of the instantiation
    a launch of J jobs x T tasks, A apps and P PEs takes (``K`` OPP levels:
    the DTPM one)."""
    fns = _kernel()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = fns["info"](int(K is not None), J, T, A, P, K or 1, out)
    _raise_on(rc, f"J {J}, T {T}, A {A}, P {P}, K {K}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm", "registers",
                     "local_bytes", "slots"), out))


def epilogue(tables, arrival: torch.Tensor, app_idx: torch.Tensor,
             scheduled, start, finish, onpe,
             onopp=None) -> Dict[str, torch.Tensor]:
    """Latency, energy and per-PE busy time of (L, J, T) schedules.

    ``arrival`` (L, J) f32 and ``app_idx`` (L, J) int are the lanes; the
    schedule (``scheduled``, ``start``, ``finish``, ``onpe``, each (L, J, T))
    passes through as it is; ``onopp`` (DTPM) prices each task at its latched
    OPP's active power.  Each lane reads its own design's tables (stacked
    tables: lane l, design l // S).  CPU tensors take
    :func:`epilogue_plain`; CUDA tensors one launch of K7 on the current
    stream (1..79 PEs), whose outputs are the plain version's bits."""
    dev = app_idx.device
    if dev.type == "cpu":
        return epilogue_plain(tables, arrival, app_idx, scheduled, start,
                              finish, onpe, onopp)
    if dev.type != "cuda":
        raise ValueError(f"epilogue: no kernel for device {dev}")
    L, J = app_idx.shape
    T = start.shape[-1]
    lanes_per_design(tables, L)                  # raises unless L = D * S
    valid = per_design(tables, "valid")
    p_act = per_design(tables, "power_active" if onopp is None
                       else "power_active_opp")
    p_idle = per_design(tables, "power_idle")
    D, A = valid.shape[:2]
    P = p_idle.shape[-1]
    K = p_act.shape[-1] if onopp is not None else 1
    if tuple(valid.shape) != (D, A, T) or tuple(start.shape) != (L, J, T):
        raise ValueError(f"epilogue: schedules {tuple(start.shape)} for {L} "
                         f"lanes of {J} jobs and tables of {T} tasks")
    cells = [start.to(torch.float32), finish.to(torch.float32),
             onpe.to(torch.int32)]
    if onopp is not None:
        cells.append(onopp.to(torch.int32))
    cells = [x.contiguous() for x in cells]
    lanes = [arrival.to(torch.float32).contiguous(),
             app_idx.to(torch.int32).contiguous()]
    consts = [valid.contiguous(), p_act.to(torch.float32).contiguous(),
              p_idle.to(torch.float32).contiguous()]
    if any(t.device != dev for t in cells + lanes + consts):
        raise ValueError(f"epilogue: the schedule, the lanes and the tables "
                         f"must all be on {dev}")
    _build.refuse_grad("epilogue", *cells, *lanes, *consts)
    job_finish = torch.empty((L, J), dtype=torch.float32, device=dev)
    makespan, latency, energy = (torch.empty(L, dtype=torch.float32,
                                             device=dev) for _ in range(3))
    busy = torch.empty((L, P), dtype=torch.float32, device=dev)
    opp_ptr = cells[3].data_ptr() if onopp is not None else None
    fns = _kernel()
    what = f"{L} lanes of {J} jobs x {T} tasks, {D} designs of {P} PEs, {A} apps"
    per_lane = fns["spill"](int(onopp is not None), J, T, A, P, K)
    _raise_on(min(per_lane, 0), what)
    # the sums' stack levels past shared memory: a few KB a lane
    spill = torch.empty(L * per_lane, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns["launch"](*[t.data_ptr() for t in cells[:3]], opp_ptr,
                           *[t.data_ptr() for t in lanes + consts],
                           spill.data_ptr() if per_lane else None,
                           job_finish.data_ptr(), makespan.data_ptr(),
                           latency.data_ptr(), energy.data_ptr(),
                           busy.data_ptr(), L, D, J, T, A, P, K, stream)
    _raise_on(rc, what)
    _metrics.counter(LAUNCHES).inc()
    return dict(finish=finish, start=start, onpe=onpe, scheduled=scheduled,
                job_finish=job_finish, makespan_us=makespan,
                avg_job_latency_us=latency, energy_j=energy,
                busy_per_pe_us=busy)
