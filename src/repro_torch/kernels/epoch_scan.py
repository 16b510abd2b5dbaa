"""K1, the DS3 epoch scan: hand-written CUDA kernel + its plain PyTorch version.

Replaces ``_epoch_scan`` of ``src/repro/core/simkernel_jax.py`` (``:321``), a
``lax.scan`` that XLA compiles (no Pallas original), for static governors and
the ``etf``, ``met`` and ``table`` schedulers.  Each step picks the ready task
with the least (ready time, job, task), finds its data-ready time on every PE
from its predecessors' finishes and PEs, lets the policy pick a PE and commits
the task to that PE's queue.  The kernel is ``csrc/epoch_scan.cu`` (design
notes at its top): one block of 256 threads per lane, the small tables and the
per-job done masks in shared memory, the (J, T) schedule in global memory.

``epoch_scan`` launches the kernel for CUDA tensors or raises; only CPU
tensors go to ``epoch_scan_plain``.  ``launches`` counts calls, one launch
each.  Both return ``scheduled``, ``start``, ``finish`` and ``onpe``, each
(L, J, T), equal bit for bit.

Three traps, handled where named:
* FMA contraction: ``startup + ebytes*inv_bw``, ``mult*base`` and
  ``finish + comm`` are rounded op by op in the reference; the kernel writes
  them with ``__fmul_rn`` / ``__fadd_rn``, and here each is its own op.
* Ties: the task pick takes the first flat index at the least ready time,
  the PE argmins the first minimum (``torch.argmin``, and the reference's
  ``min(where(tie, flat_order, 2**30))``; never the index of
  ``torch.min(dim=...)``, whose choice among ties is not documented).
* ``table_pe`` is -1 where the offline table has no entry (a JAX index of -1
  wraps to the last PE); a valid task without an entry raises before launch.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import _build

BIG = 1e30            # finite on purpose, as the reference's BIG
POLICIES = ("etf", "met", "table")
THREADS = 256         # threads per block (csrc/epoch_scan.cu)
MAX_TASKS = 32        # T: a job's done set is one 32-bit mask
MAX_SHARED = 232448   # dynamic shared bytes a block may use on Hopper

launches = 0
_fn = None
_prepared = weakref.WeakKeyDictionary()   # tables -> (pred bits, valid bits)


def _check_policy(policy: str):
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")


def _check_table(tables, policy: str):
    """A valid task the table does not assign would read PE -1; the reference
    wraps that index to the last PE.  Raise instead (once per table set)."""
    if policy == "table":
        pe = tables.table_pe
        if bool((tables.valid & ((pe < 0) | (pe >= tables.num_pes))).any()):
            raise ValueError("table policy: a valid task has no table entry "
                             f"(table_pe == -1) or one outside 0..{tables.num_pes - 1}")


def epoch_scan_plain(tables, policy: str, arrival: torch.Tensor,
                     app_idx: torch.Tensor):
    """The static epoch scan as a Python loop over its six steps, vectorised
    over lanes.  ``arrival`` (L, J) f32, ``app_idx`` (L, J) int on the tables'
    device.  Returns (scheduled, start, finish, onpe), each (L, J, T).

    In the static, fault-free scan every step commits one task while any is
    left, so the loop runs the largest count of valid tasks of any lane; a
    lane with nothing left commits into a spare slot past its last cell and
    PE, which is dropped at the end (the reference's padding steps).
    """
    _check_policy(policy)
    _check_table(tables, policy)
    dev = tables.exec_us.device
    arrival = arrival.to(dev, torch.float32)
    app_idx = app_idx.to(dev, torch.long)
    L, J = arrival.shape
    T, P = tables.t_max, tables.num_pes
    JT = J * T
    lanes = torch.arange(L, device=dev)
    pred_j = tables.pred[app_idx]                      # (L, J, T, T)
    ebytes_j = tables.ebytes[app_idx]                  # (L, J, T, T)
    valid_j = tables.valid[app_idx]                    # (L, J, T)
    exec_j = tables.exec_us[app_idx]                   # (L, J, T, P)
    table_j = tables.table_pe[app_idx].long()          # (L, J, T)
    flat_order = torch.arange(JT, device=dev).view(1, J, T)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    # the state: (L, J*T + 1) cells and (L, P + 1) queues, the last of each
    # the spare slot
    scheduled = torch.ones((L, JT + 1), dtype=torch.bool, device=dev)
    scheduled[:, :JT] = ~valid_j.view(L, JT)           # invalid = pre-done
    finish = torch.zeros((L, JT + 1), dtype=torch.float32, device=dev)
    start = torch.zeros_like(finish)
    onpe = torch.zeros((L, JT + 1), dtype=torch.long, device=dev)
    pe_free = torch.zeros((L, P + 1), dtype=torch.float32, device=dev)

    def cells(x):
        return x[:, :JT].view(L, J, T)

    for _ in range(int(valid_j.sum(dim=(1, 2)).max()) if L else 0):
        sched, fin = cells(scheduled), cells(finish)
        # 1. eligibility: tasks whose preds are all committed
        preds_open = (pred_j & ~sched[:, :, None, :]).any(dim=-1)
        eligible = ~sched & ~preds_open
        # 2. epoch time: max(arrival, max pred finish); no preds -> arrival
        pf = torch.where(pred_j, fin[:, :, None, :], -big)
        ready = torch.maximum(arrival[:, :, None], pf.amax(dim=-1))
        ready = torch.where(eligible, ready, big)
        # 3. lexicographic argmin (ready, job, task): the first flat index
        rmin = ready.amin(dim=(1, 2))                               # (L,)
        tie = eligible & (ready <= rmin[:, None, None])
        pick = torch.where(tie, flat_order, 2 ** 30).amin(dim=(1, 2))
        do_commit = rmin < BIG * 0.5
        # a lane with nothing left has no pick: any in-range index will do
        pick = torch.where(do_commit, pick, 0)
        j, t = pick // T, pick % T
        ex = exec_j[lanes, j, t]                                    # (L, P)
        # 4. per-PE data-ready with comm from the producer PEs, op by op
        mult = tables.comm_mult[cells(onpe)[lanes, j]]              # (L, T, P)
        base = tables.comm_startup + ebytes_j[lanes, j, t] * tables.comm_inv_bw
        comm = mult * base[:, :, None]
        pf_row = torch.where(pred_j[lanes, j, t], fin[lanes, j], -big)
        data_ready = torch.maximum(
            rmin[:, None], (pf_row[:, :, None] + comm).amax(dim=1))  # (L, P)
        start_c = torch.maximum(data_ready, pe_free[:, :P])
        fin_c = start_c + ex
        # 5. policy: the first minimum
        if policy == "etf":
            pe = torch.argmin(fin_c, dim=1)
        elif policy == "met":
            pe = torch.argmin(ex, dim=1)
        else:
            pe = table_j[lanes, j, t]
        # 6. commit; a lane with nothing left writes its spare slots
        s0 = torch.maximum(data_ready[lanes, pe], pe_free[lanes, pe])
        f0 = s0 + ex[lanes, pe]
        cell = torch.where(do_commit, pick, JT)
        scheduled[lanes, cell] = True
        finish[lanes, cell] = f0
        start[lanes, cell] = s0
        onpe[lanes, cell] = pe
        pe_free[lanes, torch.where(do_commit, pe, P)] = f0
    return (cells(scheduled).contiguous(), cells(start).contiguous(),
            cells(finish).contiguous(), cells(onpe).to(torch.int32))


def _bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., T) bool -> (...) int32, bit t set where mask[..., t]."""
    T = mask.shape[-1]
    weights = torch.ones(T, dtype=torch.int64, device=mask.device) \
        << torch.arange(T, device=mask.device)
    bits = (mask.long() * weights).sum(dim=-1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def _prepare(tables, policy: str):
    """Per table set, once: the shapes checked, pred and valid bit masks on
    the device, and the table check per policy."""
    hit = _prepared.get(tables)
    if hit is None:
        A, T, P = tables.exec_us.shape
        shapes = {"pred": (A, T, T), "ebytes": (A, T, T), "valid": (A, T),
                  "table_pe": (A, T), "comm_mult": (P, P)}
        for name, shape in shapes.items():
            if tuple(getattr(tables, name).shape) != shape:
                raise ValueError(f"epoch_scan: tables.{name} is "
                                 f"{tuple(getattr(tables, name).shape)}, "
                                 f"exec_us {(A, T, P)} needs {shape}")
        hit = _prepared[tables] = {"pred_bits": _bits(tables.pred).contiguous(),
                                   "valid_bits": _bits(tables.valid).contiguous(),
                                   "table_ok": set()}
    if policy not in hit["table_ok"]:
        _check_table(tables, policy)
        hit["table_ok"].add(policy)
    return hit


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("epoch_scan")
        fn = lib.repro_epoch_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        err = lib.repro_epoch_scan_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def shared_bytes(J: int, A: int, T: int, P: int) -> int:
    """Dynamic shared memory of one block (csrc/epoch_scan.cu's layout)."""
    words = A * T * P + A * T * T + P * P + 2 * A * T + A + P + 3 * J \
        + 2 * (THREADS // 32)
    return 4 * words


def kernel_info(J: int, A: int, T: int, P: int, device=None) -> dict:
    """Threads per block, resident blocks per SM and dynamic shared bytes of
    one launch at these sizes."""
    lib = _build.load("epoch_scan")
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = lib.repro_epoch_scan_info(J, A, T, P, out)
    if rc != 0:
        raise RuntimeError(f"epoch_scan info failed: {_kernel()[1](rc).decode()}")
    info = dict(zip(("threads", "blocks_per_sm", "shared_bytes"), out))
    if (info["threads"], info["shared_bytes"]) != (THREADS,
                                                   shared_bytes(J, A, T, P)):
        raise RuntimeError(f"epoch_scan: csrc/epoch_scan.cu's geometry {info} "
                           "differs from epoch_scan.py's")
    return info


def epoch_scan(tables, policy: str, arrival: torch.Tensor,
               app_idx: torch.Tensor):
    """(L, J) lanes of one table set -> (scheduled, start, finish, onpe), each
    (L, J, T).  CPU tensors take the plain version; CUDA tensors one launch."""
    _check_policy(policy)
    dev = tables.exec_us.device
    if dev.type == "cpu":
        return epoch_scan_plain(tables, policy, arrival, app_idx)
    if dev.type != "cuda":
        raise ValueError(f"epoch_scan: no kernel for device {dev}")
    if arrival.device != dev or app_idx.device != dev:
        raise ValueError(f"epoch_scan: lanes on {arrival.device} / "
                         f"{app_idx.device}, tables on {dev}")
    if arrival.ndim != 2 or app_idx.shape != arrival.shape:
        raise ValueError(f"epoch_scan: arrival {tuple(arrival.shape)}, app_idx "
                         f"{tuple(app_idx.shape)}; both (L, J)")
    L, J = arrival.shape
    A, T, P = tables.exec_us.shape
    if not 1 <= T <= MAX_TASKS:
        raise ValueError(f"epoch_scan: {T} tasks a job; the kernel takes "
                         f"1..{MAX_TASKS}")
    if L == 0 or J == 0:
        raise ValueError("epoch_scan: no lanes or no jobs")
    if shared_bytes(J, A, T, P) > MAX_SHARED:
        raise ValueError(f"epoch_scan: {J} jobs of {T} tasks on {P} PEs need "
                         f"{shared_bytes(J, A, T, P)} bytes of shared memory a "
                         f"block; the card has {MAX_SHARED}")
    if bool(((app_idx < 0) | (app_idx >= A)).any()):
        raise ValueError(f"epoch_scan: an app index outside 0..{A - 1}")
    prep = _prepare(tables, policy)
    arrival = arrival.to(torch.float32).contiguous()
    app_idx = app_idx.to(torch.int32).contiguous()
    f32 = [t.to(torch.float32).contiguous() for t in
           (tables.exec_us, tables.ebytes, tables.comm_mult,
            tables.comm_startup.reshape(1), tables.comm_inv_bw.reshape(1))]
    table_pe = tables.table_pe.to(torch.int32).contiguous()
    scheduled = torch.empty((L, J, T), dtype=torch.bool, device=dev)
    start = torch.empty((L, J, T), dtype=torch.float32, device=dev)
    finish = torch.empty_like(start)
    onpe = torch.empty((L, J, T), dtype=torch.int32, device=dev)
    fn, err = _kernel()
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # one design (D = 1): its L lanes are the (1, S) lane grid
        rc = fn(f32[0].data_ptr(), prep["pred_bits"].data_ptr(),
                f32[1].data_ptr(), prep["valid_bits"].data_ptr(),
                f32[2].data_ptr(), f32[3].data_ptr(), f32[4].data_ptr(),
                table_pe.data_ptr(), arrival.data_ptr(), app_idx.data_ptr(),
                scheduled.data_ptr(), start.data_ptr(), finish.data_ptr(),
                onpe.data_ptr(), 1, L, J, A, T, P, POLICIES.index(policy),
                stream)
    if rc != 0:
        raise RuntimeError(f"epoch_scan launch failed: {err(rc).decode()}")
    launches += 1
    return scheduled, start, finish, onpe
