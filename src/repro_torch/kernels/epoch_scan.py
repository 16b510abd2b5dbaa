"""K1, the DS3 epoch scan: hand-written CUDA kernel + its plain PyTorch version.

Replaces ``_epoch_scan`` of ``src/repro/core/simkernel_jax.py`` (``:321``), a
``lax.scan`` that XLA compiles (no Pallas original), for the ``etf``, ``met``
and ``table`` schedulers, in the reference's four programs: static governors
(``gov=None``) and closed-loop DTPM (``gov`` a ``core.dvfs.PolicyLanes``:
ondemand and throttle), each without faults or, under etf and met, with
fail-stop faults (``faults``: (L, P) f32 fail times, ``inf`` never).  Each
step picks the ready task with the least (ready time, job, task), finds its
data-ready time on every PE from its predecessors' finishes and PEs, lets the
policy pick a PE and commits the task to that PE's queue.  The kernel is
``csrc/epoch_scan.cuh`` (design notes at its top): a block of one warp
per lane, the small tables of its design and the jobs' done masks and keys in
shared memory, the (J, T) schedule in global memory.  A step picks the least
per-job key, places the task and recomputes only its job's key; under DTPM a
window sums each PE's commit list from its moving head.  DTPM and faults are
compile-time variants of it, four instantiations in all, the fault-free ones
built from ``csrc/epoch_scan.cu``, the fail-stop ones from
``csrc/epoch_scan_faults.cu``.

The tables are one design's (``exec_us`` (A, T, P)) or a stack of D designs
padded to one shape (every field with a leading design axis, ``exec_us``
(D, A, T, P); ``dse.batch.stack_tables``).  Lanes are design-major, (D*S,
J): lane l reads design l // S, in the kernel and in the plain version
alike, and every per-lane input (arrival, app index, policy, fail times) is
laid out in that order.  Each lane's window sums take their fixed-point
exponents from its own design's largest active power (:func:`quanta`), so a
lane of a stack equals the same lane run on its design alone.

``epoch_scan`` launches the kernel for CUDA tensors or raises; only CPU
tensors go to ``epoch_scan_plain``.  ``launches`` counts calls, one launch
each, and ``variant_launches`` the same calls by instantiation, keyed (DTPM,
FAULTS).  Both return ``scheduled``, ``start``, ``finish`` and ``onpe``, each
(L, J, T), under DTPM also ``onopp`` (L, J, T), ``opp_idx`` (L, C) and
``peak_temp_c`` (L,), and with faults last ``counts`` (L, 2) int32 (the steps
a lane took and the tasks it committed, re-commits included), equal bit for
bit.

Fail-stop faults, the reference's ``apply_faults`` (``:402-435``) and its
``fired`` / ``floor`` carry (``:372-376``): a step whose least ready time
crosses a PE's fail time first rolls back, as one union over the PEs firing
together, the committed tasks on those PEs that finish after the fail time
and their committed descendants; the queues drain at the surviving finishes;
a rolled-back task none of whose preds was lost waits out the fail time
(``floor``), one with a lost pred drops its floor.  The step's pick is then
skipped if a pred of it was rolled back, else placed at the pre-rollback
ready time, dead PEs taking ``inf`` in the policy's argmin (every PE dead:
PE 0, as ``argmin``).  The scan runs until no task is left, at most
``scenario.faults.fault_scan_steps`` steps.

DTPM, the reference's ``_window_step`` (``:271``): before each commit the
sampling windows that closed by the pick's ready time run (the lazy advance,
``:471-480``); the pick's latency is then read at its PEs' domain OPPs from
``exec_opp`` and the commit latches the OPP (``onopp``); after the last commit
the windows drain to the makespan (``:535-543``).  Stopping at the first empty
step stays exact: without faults a step that commits nothing sets ``now =
-BIG`` and advances no window.  A window's sums (per-PE busy time and active
energy, per-domain CPU busy time) are taken in 64-bit fixed point, each term
``round(x * 2**s)`` with ``s`` from the lane's window (:func:`quanta`), so
they are exact integer sums that no order changes: the kernel's and the plain
version's agree bit for bit (the reference's einsums round in XLA's order;
the tests hold the port to it within 1e-5).  The node power ``p_pe @
node_oh`` is a fixed tree over 32 PE slots, the RC step ``A @ temps + B @ u``
a left-to-right sum of rounded products, in both versions.

Three traps, handled where named:
* FMA contraction: ``startup + ebytes*inv_bw``, ``mult*base`` and
  ``finish + comm`` are rounded op by op in the reference; the kernel writes
  them with ``__fmul_rn`` / ``__fadd_rn``, and here each is its own op.  The
  window step's products and sums are written the same way (never
  ``torch.matmul``, whose order and fusion on the card are not specified).
* Ties: the task pick takes the first flat index at the least ready time,
  the PE argmins the first minimum (``torch.argmin``, and the reference's
  ``min(where(tie, flat_order, 2**30))``; never the index of
  ``torch.min(dim=...)``, whose choice among ties is not documented).
* ``table_pe`` is -1 where the offline table has no entry (a JAX index of -1
  wraps to the last PE); a valid task without an entry raises before launch.
* Faults: the fire test reads the least ready time from before the rollback,
  the PE choice the schedule from after it; a dead PE is ``inf`` in the
  argmin (not excluded through the queues: the reference recomputes them only
  when a task was lost); a task whose pred was lost gets floor 0 even if an
  earlier fault had set one.
"""
from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch

from ..obs import metrics as _metrics
from . import _build

BIG = 1e30            # finite on purpose, as the reference's BIG
POLICIES = ("etf", "met", "table")
MAX_TASKS = 32        # T: a job's done set is one 32-bit mask
MAX_SHARED = 232448   # dynamic shared bytes a block may use on Hopper
MAX_PES_DTPM = 32     # DTPM: P, C and K, a lane of the warp each
QUANTUM_BITS = 47     # a window's fixed-point term is below 2**47

launches = 0
# the four instantiations, (DTPM, FAULTS) -> the name reports give them
VARIANT_NAMES = {(False, False): "epoch_scan", (True, False): "epoch_scan_dtpm",
                 (False, True): "epoch_scan_faults",
                 (True, True): "epoch_scan_dtpm_faults"}
# launches by instantiation: (DTPM, FAULTS) -> count, each also in `launches`
variant_launches = dict.fromkeys(VARIANT_NAMES, 0)
_fn = None
_prepared = weakref.WeakKeyDictionary()   # tables -> (pred bits, valid bits)


def _check_policy(policy: str):
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")


def designs(tables) -> int:
    """D of stacked tables (``exec_us`` (D, A, T, P)); 0 for one design's."""
    return int(tables.exec_us.shape[0]) if tables.exec_us.ndim == 4 else 0


def per_design(tables, name: str) -> torch.Tensor:
    """Field ``name`` with a leading design axis: as it is for stacked tables,
    a (1, ...) view for one design's."""
    x = getattr(tables, name)
    return x if designs(tables) else x.unsqueeze(0)


def lanes_per_design(tables, L: int) -> int:
    """S of L = D*S design-major lanes (L for one design's tables)."""
    D = max(designs(tables), 1)
    if L % D:
        raise ValueError(f"epoch_scan: {L} lanes do not split evenly over "
                         f"{D} designs (lanes are (D*S, J), design-major)")
    return L // D


def lane_designs(tables, L: int, device=None) -> torch.Tensor:
    """(L,) int64: the design each lane reads, l // S for L = D*S
    design-major lanes (all 0 for one design's tables)."""
    return torch.arange(L, device=device) // max(lanes_per_design(tables, L), 1)


def lane_p_max(tables, L: int) -> list:
    """Each lane's design's largest active power (the DTPM tables'
    ``power_active_opp``), the scale :func:`quanta` takes per lane."""
    # lint: waive TX001 -- once a launch: the exponents are host integers
    p_max = per_design(tables, "power_active_opp").flatten(1).amax(1).tolist()
    # lint: waive TX001 -- once a launch: each lane's design, on the host
    return [p_max[d] for d in lane_designs(tables, L).tolist()]


def _check_table(tables, policy: str):
    """A valid task the table does not assign would read PE -1; the reference
    wraps that index to the last PE.  Raise instead (once per table set; per
    design of a stack, elementwise)."""
    if policy == "table":
        pe = tables.table_pe
        # lint: waive TX001 -- a check once a launch: a bad entry reads PE -1
        if bool((tables.valid & ((pe < 0) | (pe >= tables.num_pes))).any()):
            raise ValueError("table policy: a valid task has no table entry "
                             f"(table_pe == -1) or one outside 0..{tables.num_pes - 1}")


def rc_consts() -> np.ndarray:
    """The RC step's constants as the reference rounds them, f32: the node
    capacitances, the ambient drive T_amb / (R_board * C_board), and the
    ambient temperature the carry starts at.  (``core`` imports this module,
    so it is imported here at call time.)"""
    from ..core import thermal
    return np.array([*np.float32(thermal.C_NODE),
                     thermal.T_AMBIENT_C / (thermal.R_BOARD_AMB * thermal.C_BOARD),
                     thermal.T_AMBIENT_C], np.float32)


def quanta(window: torch.Tensor, p_max) -> torch.Tensor:
    """(L, 2) int32 exponents ``(s_busy, s_energy)`` of each lane's window
    sums, ``p_max`` one active power for every lane or a sequence of L (each
    lane's design's, :func:`lane_p_max`): a term ``x`` (an overlap, at most
    the window; or an overlap times an active power, at most ``window *
    p_max``) counts as
    ``round(x * 2**s)``, below ``2**QUANTUM_BITS``.  Tasks on one PE do not
    overlap, so a PE's window sum stays below ``2**(QUANTUM_BITS + 1)`` (the
    roundings add at most half a unit a term) and a domain's of at most 32
    PEs below 2**53: exact in int64 and in a double, in any order."""
    windows = window.tolist()  # lint: waive TX001 -- once a launch, host ints
    if isinstance(p_max, (int, float)):
        p_max = [p_max] * len(windows)
    out = []
    for w, p in zip(windows, p_max):
        out.append((QUANTUM_BITS - math.frexp(w)[1],
                    QUANTUM_BITS - math.frexp(w * p)[1]))
    if any(abs(s) > 126 for pair in out for s in pair):
        raise ValueError(f"epoch_scan: a window of {windows} us or an "
                         f"active power of {max(p_max)} W is out of the f32 range "
                         "the window sums take")
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 2)


def _check_dtpm(tables, gov, L: int):
    if tables.exec_opp is None:
        raise ValueError("tables lack OPP ladders; build them with the "
                         "dynamic governor (build_tables(governor=...))")
    if gov.lanes != L:
        raise ValueError(f"epoch_scan: policies for {gov.lanes} lanes, "
                         f"{L} lanes of jobs")
    C, K = tables.opp_freq.shape[-2:]
    if max(tables.num_pes, C, K) > MAX_PES_DTPM:
        raise ValueError(f"epoch_scan: DTPM takes at most {MAX_PES_DTPM} PEs, "
                         f"domains and OPP levels; have {tables.num_pes}, "
                         f"{C}, {K}")


def fixed_sums(terms: torch.Tensor, scales: torch.Tensor,
               index: torch.Tensor, bins: int) -> torch.Tensor:
    """(..., bins) int64 sums of the (..., N) f32 ``terms`` by ``index``, in
    fixed point: ``round(term * scale)`` each, half to even as the kernel's
    ``__float2ll_rn``.  Integer adds are exact, so no order of them (the
    kernel's atomics, torch's scatter) changes a bit."""
    q = torch.round(terms * scales).long()
    acc = torch.zeros(q.shape[:-1] + (bins,), dtype=torch.long, device=q.device)
    return acc.scatter_add_(-1, index.expand_as(q), q)


class _Windows:
    """The DTPM carry of the plain scan, all lanes at once: per-domain OPP
    index (and its gather per PE), the next window's end, the RC
    temperatures and their peak.  Each lane reads its own design's tables
    (``design``: (L,) its index into the stack).  :meth:`step` runs one
    sampling window on the lanes of a mask, in the kernel's arithmetic (see
    the module's docstring).  Every constant is made on the device once: a tensor made
    from host data on each call would synchronise the stream."""

    def __init__(self, tables, gov, design: torch.Tensor, dev):
        from ..core import dvfs
        self.ondemand_index = dvfs.ondemand_index_torch
        self.throttle_index = dvfs.throttle_index_torch
        L = design.shape[0]
        C, K = tables.opp_freq.shape[-2:]
        P = tables.num_pes
        self.K, self.P = K, P

        def lane(name):
            return per_design(tables, name)[design]               # (L, ...)
        self.window = gov.window.to(dev)
        self.up, self.cap = gov.up.to(dev), gov.cap.to(dev)
        self.A_rc, self.B_rc = gov.A_rc.to(dev), gov.B_rc.to(dev)
        self.scales, self.backs = window_scales(gov.window,
                                                lane_p_max(tables, L), dev)
        rc = torch.from_numpy(rc_consts()).to(dev)
        self.c_node, self.amb_drive = rc[:3], rc[3:4]
        self.floor = torch.tensor(np.float32(1e-9), device=dev)
        self.power_opp = lane("power_active_opp").reshape(L, P * K)  # (L, P*K)
        self.power_idle = lane("power_idle")                          # (L, P)
        self.opp_freq, self.num_opp = lane("opp_freq"), lane("num_opp")
        self.domain_cpu = lane("domain_cpu")                          # (L, C)
        pe_domain = lane("pe_domain").long()                          # (L, P)
        self.cpu_dom = cpu_domains(pe_domain, lane("pe_is_cpu"), C)   # (L, P, C)
        self.node_mask = node_mask(lane("node_of_pe"), MAX_PES_DTPM)  # (L, 3, 32)
        self.pe_domain = pe_domain
        self.domain_node = lane("domain_node").long()                 # (L, C)
        self.opp_idx = torch.zeros((L, C), dtype=torch.long, device=dev)
        self.opp_pe = self.opp_idx.gather(1, pe_domain)               # (L, P)
        self.next_w = self.window.clone()
        self.temps = torch.full((L, 4), float(rc[4]), device=dev)
        self.peak = torch.full((L,), float(rc[4]), device=dev)

    def step(self, due, committed, start, finish, onpe, onopp):
        """One window ``[next_w - window, next_w)`` on the lanes where
        ``due``; the cells (L, N): ``committed`` (scheduled and valid), their
        start, finish, PE and latched OPP.  Returns the window's (L, C)
        utilisation and (L, 3) node power (every lane's: a lane not due
        keeps its carry, and its values are not meant to be read), as the
        reference's ``_window_step`` returns them to the telemetry replay."""
        window = self.window[:, None]
        w1 = self.next_w[:, None]
        ov = torch.minimum(torch.clamp(torch.minimum(finish, w1)
                                       - torch.maximum(start, w1 - window),
                                       min=0.0), window)
        ov = torch.where(committed, ov, 0.0)
        # exact per-PE sums of busy time and of active energy at the
        # latched OPP
        p_cell = self.power_opp.gather(1, onpe * self.K + onopp)
        busy_pe, e_act, busy_dom = window_sums(ov, p_cell, onpe, self.scales,
                                               self.backs, self.cpu_dom, self.P)
        # the governor: utilisation -> ondemand proposal
        util = busy_dom / torch.maximum(window * self.domain_cpu, self.floor)
        proposed = self.ondemand_index(self.opp_freq, self.num_opp, self.up,
                                       util)
        # realised window power per PE and node, then the RC step
        idle_frac = 1.0 - torch.clamp(busy_pe / window, 0.0, 1.0)
        p_pe = e_act / window + self.power_idle * idle_frac
        node_p = node_power(p_pe, self.node_mask)
        temps = rc_step(self.A_rc, self.B_rc, self.temps, node_p, self.c_node,
                        self.amb_drive)
        peak = torch.maximum(self.peak, temps[:, :3].amax(dim=1))
        opp = self.throttle_index(proposed, temps.gather(1, self.domain_node),
                                  self.cap)
        self.opp_idx = torch.where(due[:, None], opp, self.opp_idx)
        self.opp_pe = self.opp_idx.gather(1, self.pe_domain)
        self.temps = torch.where(due[:, None], temps, self.temps)
        self.peak = torch.where(due, peak, self.peak)
        self.next_w = torch.where(due, self.next_w + self.window, self.next_w)
        return util, node_p

    def advance(self, until, *cells):
        """Windows while ``until()`` holds on any lane, masked per lane."""
        while True:
            due = until()
            if not bool(due.any()):
                return
            self.step(due, *cells)


def _rc_rows(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(L, 4, 4) @ (L, 4) as left-to-right sums of rounded products."""
    prod = M * v[:, None, :]
    acc = prod[:, :, 0]
    for k in range(1, M.shape[2]):
        acc = acc + prod[:, :, k]
    return acc


def window_scales(window: torch.Tensor, p_max, dev):
    """(L, 2, 1) f32 ``2**s`` that scale a window's terms in and (L, 2, 1)
    f64 ``2**-s`` that scale its sums out, ``s`` each lane's
    :func:`quanta` (both exact powers of two)."""
    q = quanta(window, p_max).tolist()
    scales = torch.tensor([[[2.0 ** sb], [2.0 ** se]] for sb, se in q],
                          dtype=torch.float32, device=dev)
    backs = torch.tensor([[[2.0 ** -sb], [2.0 ** -se]] for sb, se in q],
                         dtype=torch.float64, device=dev)
    return scales, backs


def cpu_domains(pe_domain: torch.Tensor, pe_is_cpu: torch.Tensor,
                C: int) -> torch.Tensor:
    """(L, P, C) f64: 1 where a CPU PE is in a domain.  The integer busy
    sums (each below 2**48, at most 32 of them) add exactly in f64."""
    dom = pe_domain.long()[:, :, None] == torch.arange(C, device=pe_domain.device)
    return (dom & (pe_is_cpu != 0)[:, :, None]).double()


def node_mask(node_of_pe: torch.Tensor, width: int) -> torch.Tensor:
    """(L, 3, width) f32: 1 where a PE slot is on a thermal node, slots past
    the (L, P) map 0; ``width`` a power of two, the leaves of
    :func:`node_power`'s tree."""
    from ..core.thermal import NUM_NODES
    L, P = node_of_pe.shape
    node = torch.full((L, width), -1, dtype=torch.long, device=node_of_pe.device)
    node[:, :P] = node_of_pe.long()
    return (node[:, None, :] == torch.arange(
        NUM_NODES, device=node.device)[:, None]).float()


def window_sums(ov, p_cell, onpe, scales, backs, cpu_dom, P: int):
    """One window's sums over the (L, N) cells, each term in fixed point
    (:func:`fixed_sums`): per-PE busy time and active energy ``ov *
    p_cell`` (L, P) and per-domain CPU busy time (L, C), as f32."""
    acc = fixed_sums(torch.stack([ov, ov * p_cell], dim=1), scales,
                     onpe[:, None, :], P).double()                  # (L, 2, P)
    busy_pe, e_act = (acc * backs).float().unbind(1)
    busy_dom = ((acc[:, 0, :, None] * cpu_dom).sum(dim=1)
                * backs[:, 0]).float()
    return busy_pe, e_act, busy_dom


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise tree: the axis is padded
    with zeros to a power of two and halved, each step one elementwise add.
    A row's bits thus depend on that row only, never on the rows beside it
    in a call or on how a device splits a reduction; padding an axis further
    with zeros changes no bit."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def node_power(p_pe: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(L, P) PE power -> (L, 3) node power by a fixed tree over the mask's
    slots (times 1 or 0: exact), as the kernel's warp shuffles."""
    x = torch.nn.functional.pad(p_pe, (0, mask.shape[-1] - p_pe.shape[-1]))
    return tree_sum(x[:, None, :] * mask)


def rc_step(A, B, temps, node_p, c_node, amb_drive) -> torch.Tensor:
    """The exact RC step ``A @ temps + B @ u`` of (L, 4) temperatures under
    (L, 3) node power, each product and sum rounded on its own."""
    u = torch.cat([node_p / c_node, amb_drive.expand(node_p.shape[0], 1)],
                  dim=1)                                            # (L, 4)
    return _rc_rows(A, temps) + _rc_rows(B, u)


def epoch_scan_plain(tables, policy: str, arrival: torch.Tensor,
                     app_idx: torch.Tensor, gov=None, faults=None):
    """The epoch scan as a Python loop over its six steps, vectorised over
    lanes.  ``arrival`` (L, J) f32, ``app_idx`` (L, J) int on the tables'
    device (design-major over stacked tables: lane l reads design l // S);
    ``gov`` a ``core.dvfs.PolicyLanes`` of L lanes runs the DTPM program;
    ``faults`` (L, P) f32 fail times (``inf``: never) the fail-stop
    program.  Returns (scheduled, start, finish, onpe), each (L, J, T), under
    DTPM then (onopp (L, J, T), opp_idx (L, C), peak_temp_c (L,)), and with
    faults last ``counts`` (L, 2) int32: the steps each lane took and the
    tasks it committed, re-commits included.

    Without faults every step commits one task while any is left, so the
    loop runs the largest count of valid tasks of any lane; a lane with
    nothing left commits into a spare slot past its last cell and PE, which
    is dropped at the end (the reference's padding steps).  With faults a
    step may roll back (:func:`_roll_back`) and skip its stale pick, which
    also commits into the spare slot; the loop runs until no lane has a task
    left, at most ``fault_scan_steps(J, T, n)`` steps for the most finite
    fail times ``n`` of a lane (the reference's bound, which never binds).
    Under DTPM the windows of each step run until no lane has one due; a
    lane whose next window is not due is masked.
    """
    _check_policy(policy)
    dev = tables.exec_us.device
    arrival = arrival.to(dev, torch.float32)
    app_idx = app_idx.to(dev, torch.long)
    L, J = arrival.shape
    T, P = tables.t_max, tables.num_pes
    if faults is not None:
        faults = _check_faults(faults, policy, L, P).to(dev)
    _check_table(tables, policy)
    JT = J * T
    dtpm = gov is not None
    faulted = faults is not None
    lanes = torch.arange(L, device=dev)
    # each lane's tables, gathered by (its design, the job's app)
    design = lane_designs(tables, L, dev)               # (L,)
    lane_app = (design[:, None], app_idx)
    pred_j = per_design(tables, "pred")[lane_app]      # (L, J, T, T)
    ebytes_j = per_design(tables, "ebytes")[lane_app]  # (L, J, T, T)
    valid_j = per_design(tables, "valid")[lane_app]    # (L, J, T)
    table_j = per_design(tables, "table_pe")[lane_app].long()   # (L, J, T)
    comm_mult = per_design(tables, "comm_mult")         # (D, P, P)
    startup = per_design(tables, "comm_startup")[design][:, None]   # (L, 1)
    inv_bw = per_design(tables, "comm_inv_bw")[design][:, None]
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
    if dtpm:
        _check_dtpm(tables, gov, L)
        win = _Windows(tables, gov, design, dev)
        exec_opp = per_design(tables, "exec_opp")
        onopp = torch.zeros_like(onpe)
        valid_cells = valid_j.view(L, JT)
        ar_p = torch.arange(P, device=dev)

        def window_cells():
            return (scheduled[:, :JT] & valid_cells, start[:, :JT],
                    finish[:, :JT], onpe[:, :JT], onopp[:, :JT])
    else:
        exec_j = per_design(tables, "exec_us")[lane_app]   # (L, J, T, P)

    def cells(x):
        return x[:, :JT].view(L, J, T)

    min_steps = int(valid_j.sum(dim=(1, 2)).max()) if L else 0
    steps = min_steps
    if faulted:
        from ..scenario.faults import fault_scan_steps   # scenario imports core
        fired = torch.zeros((L, P), dtype=torch.bool, device=dev)
        floor = torch.zeros((L, J, T), dtype=torch.float32, device=dev)
        counts = torch.zeros((L, 2), dtype=torch.int32, device=dev)
        steps = fault_scan_steps(J, T, int(torch.isfinite(faults).sum(1).max()))
    for step in range(steps):
        sched, fin = cells(scheduled), cells(finish)
        # 1. eligibility: tasks whose preds are all committed
        preds_open = (pred_j & ~sched[:, :, None, :]).any(dim=-1)
        eligible = ~sched & ~preds_open
        # 2. epoch time: max(arrival, max pred finish); no preds -> arrival;
        # a rolled-back fault victim also waits out its fail time (floor)
        pf = torch.where(pred_j, fin[:, :, None, :], -big)
        ready = torch.maximum(arrival[:, :, None], pf.amax(dim=-1))
        if faulted:
            ready = torch.maximum(ready, floor)
        ready = torch.where(eligible, ready, big)
        # 3. lexicographic argmin (ready, job, task): the first flat index
        rmin = ready.amin(dim=(1, 2))                               # (L,)
        tie = eligible & (ready <= rmin[:, None, None])
        pick = torch.where(tie, flat_order, 2 ** 30).amin(dim=(1, 2))
        do_commit = rmin < BIG * 0.5
        # a lane with nothing left has no pick: any in-range index will do
        pick = torch.where(do_commit, pick, 0)
        j, t = pick // T, pick % T
        if faulted:
            if step >= min_steps and not bool(do_commit.any()):
                break                   # nothing left anywhere: no-ops follow
            counts[:, 0] += do_commit
            # 3a. the fail times this epoch crosses fire first, as one union
            # rollback a lane; a pick whose pred was rolled back is skipped
            fire = ~fired & (faults <= rmin[:, None]) & do_commit[:, None]
            if bool(fire.any()):
                _roll_back(fire, faults, fired, floor, pred_j, valid_j,
                           sched, fin, cells(start), cells(onpe), pe_free,
                           cells(onopp) if dtpm else None)
                stale = (pred_j[lanes, j, t] & ~sched[lanes, j]).any(dim=-1)
                do_commit = do_commit & ~stale
            counts[:, 1] += do_commit
        if dtpm:
            # 3b. the windows closed by this epoch, then latency at the OPPs
            now = torch.where(do_commit, rmin, -big)
            win.advance(lambda: win.next_w <= now, *window_cells())
            ex = exec_opp[design[:, None], app_idx[lanes, j][:, None],
                          t[:, None], ar_p, win.opp_pe]             # (L, P)
        else:
            ex = exec_j[lanes, j, t]                                # (L, P)
        # 4. per-PE data-ready with comm from the producer PEs, op by op
        mult = comm_mult[design[:, None], cells(onpe)[lanes, j]]    # (L, T, P)
        base = startup + ebytes_j[lanes, j, t] * inv_bw
        comm = mult * base[:, :, None]
        pf_row = torch.where(pred_j[lanes, j, t], fin[lanes, j], -big)
        data_ready = torch.maximum(
            rmin[:, None], (pf_row[:, :, None] + comm).amax(dim=1))  # (L, P)
        start_c = torch.maximum(data_ready, pe_free[:, :P])
        fin_c = start_c + ex
        # 5. policy: the first minimum; a dead PE is inf (all dead: PE 0)
        if policy == "etf":
            pe = torch.argmin(torch.where(fired, math.inf, fin_c) if faulted
                              else fin_c, dim=1)
        elif policy == "met":
            pe = torch.argmin(torch.where(fired, math.inf, ex) if faulted
                              else ex, dim=1)
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
        if dtpm:
            onopp[lanes, cell] = win.opp_pe[lanes, pe]
    out = (cells(scheduled).contiguous(), cells(start).contiguous(),
           cells(finish).contiguous(), cells(onpe).to(torch.int32))
    if dtpm:
        # drain the windows between the last decision epoch and the makespan
        makespan = torch.where(valid_j, cells(finish), 0.0).amax(dim=(1, 2))
        win.advance(lambda: win.next_w - win.window < makespan, *window_cells())
        out += (cells(onopp).to(torch.int32), win.opp_idx.to(torch.int32),
                win.peak)
    return out + (counts,) if faulted else out


def _roll_back(fire, faults, fired, floor, pred_j, valid_j, sched, fin,
               start, onpe, pe_free, onopp=None):
    """The reference's ``apply_faults`` (``simkernel_jax.py:402-435``) on the
    lanes where ``fire`` (L, P) holds, in place on the (L, J, T) cell views
    and the (L, P + 1) queues; a lane where nothing fires is left as it was.
    The committed tasks on a firing PE that finish after its fail time, and
    their committed descendants (closed over T rounds), are reset; each
    lane's queues are recomputed from its surviving schedule if it lost a
    task; a lost task none of whose preds was lost (a root) waits out its
    fail time, one with a lost pred (committed or not) drops its floor."""
    L, J, T = sched.shape
    P = fire.shape[1]
    committed = sched & valid_j
    pe_cells = onpe.reshape(L, J * T)
    ftime = faults.gather(1, pe_cells).view(L, J, T)
    inv = committed & fire.gather(1, pe_cells).view(L, J, T) & (fin > ftime)
    for _ in range(T):
        inv = inv | (committed & (pred_j & inv[:, :, None, :]).any(dim=-1))
    any_pred_inv = (pred_j & inv[:, :, None, :]).any(dim=-1)
    roots = inv & ~any_pred_inv
    sched &= ~inv
    fin.masked_fill_(inv, 0.0)
    start.masked_fill_(inv, 0.0)
    onpe.masked_fill_(inv, 0)
    if onopp is not None:
        onopp.masked_fill_(inv, 0)
    survivors = torch.where(sched & valid_j, fin, 0.0).reshape(L, J * T)
    recomputed = torch.zeros((L, P), dtype=torch.float32, device=fin.device) \
        .scatter_reduce_(1, pe_cells, survivors, "amax")
    lost = inv.flatten(1).any(dim=1, keepdim=True)
    pe_free[:, :P] = torch.where(lost, recomputed, pe_free[:, :P])
    floor.copy_(torch.where(roots, ftime, torch.where(any_pred_inv, 0.0, floor)))
    fired |= fire


def _check_faults(faults, policy: str, L: int, P: int) -> torch.Tensor:
    """(L, P) f32 fail-time plans; the table policy pins each task to its
    PE and cannot route around a dead one (the reference raises too)."""
    if policy == "table":
        raise ValueError(
            "fail-stop injection needs a PE-masking scheduler; the table "
            "policy pins static assignments — use met/etf (DESIGN.md §14)")
    faults = torch.as_tensor(faults)
    if faults.shape != (L, P):
        raise ValueError(f"epoch_scan: fault plans {tuple(faults.shape)}, "
                         f"{L} lanes of {P} PEs need {(L, P)}")
    # lint: waive TX001 -- a check once a launch: NaN would never fire
    if bool(torch.isnan(faults).any()):
        raise ValueError("epoch_scan: a fail time is NaN")
    return faults.to(torch.float32)


def _bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., T) bool -> (...) int32, bit t set where mask[..., t]."""
    T = mask.shape[-1]
    weights = torch.ones(T, dtype=torch.int64, device=mask.device) \
        << torch.arange(T, device=mask.device)
    bits = (mask.long() * weights).sum(dim=-1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def _check_shapes(tables, shapes: dict, lead: tuple, what: str):
    for name, shape in shapes.items():
        if tuple(getattr(tables, name).shape) != lead + shape:
            raise ValueError(f"epoch_scan: tables.{name} is "
                             f"{tuple(getattr(tables, name).shape)}, {what} "
                             f"needs {lead + shape}")


def _prepare(tables, policy: str):
    """Per table set, once: the shapes checked (with the leading design axis
    of stacked tables), pred and valid bit masks on the device, and the
    table check per policy."""
    hit = _prepared.get(tables)
    if hit is None:
        *lead, A, T, P = tables.exec_us.shape
        lead = tuple(lead)
        if len(lead) > 1:
            raise ValueError(f"epoch_scan: tables.exec_us is "
                             f"{tuple(tables.exec_us.shape)}; (A, T, P) or "
                             "(D, A, T, P)")
        _check_shapes(tables, {"pred": (A, T, T), "ebytes": (A, T, T),
                               "valid": (A, T), "table_pe": (A, T),
                               "comm_mult": (P, P), "comm_startup": (),
                               "comm_inv_bw": ()},
                      lead, f"exec_us {lead + (A, T, P)}")
        hit = _prepared[tables] = {"pred_bits": _bits(tables.pred).contiguous(),
                                   "valid_bits": _bits(tables.valid).contiguous(),
                                   "table_ok": set()}
        if tables.exec_opp is not None:
            (C, K), i32 = tables.opp_freq.shape[-2:], torch.int32
            _check_shapes(tables, {
                "exec_opp": (A, T, P, K), "power_active_opp": (P, K),
                "opp_freq": (C, K), "num_opp": (C,), "domain_node": (C,),
                "domain_cpu": (C,), "pe_domain": (P,), "pe_is_cpu": (P,),
                "node_of_pe": (P,), "power_idle": (P,)},
                lead, f"opp_freq {lead + (C, K)}")
            # the DTPM tables in the kernel's argument order
            hit["dtpm"] = [
                tables.exec_opp.float().contiguous(),
                tables.power_active_opp.float().contiguous(),
                tables.opp_freq.float().contiguous(),
                tables.num_opp.to(i32).contiguous(),
                tables.domain_node.to(i32).contiguous(),
                tables.domain_cpu.float().contiguous(),
                tables.pe_domain.to(i32).contiguous(),
                tables.pe_is_cpu.float().contiguous(),
                tables.node_of_pe.to(i32).contiguous(),
                tables.power_idle.float().contiguous(),
                torch.from_numpy(rc_consts()).to(tables.exec_opp.device)]
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
        fn_dtpm = lib.repro_epoch_scan_dtpm
        fn_dtpm.restype = ctypes.c_int
        fn_dtpm.argtypes = [ctypes.c_void_p] * 34 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        # the fail-stop entries (their own library, csrc/epoch_scan_faults.cu):
        # the same arguments, then the plans, the floor scratch, the counts
        # and the step cap
        lib = _build.load("epoch_scan_faults")
        fn_faults = lib.repro_epoch_scan_faults
        fn_faults.restype = ctypes.c_int
        fn_faults.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn_dtpm_faults = lib.repro_epoch_scan_dtpm_faults
        fn_dtpm_faults.restype = ctypes.c_int
        fn_dtpm_faults.argtypes = [ctypes.c_void_p] * 37 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        err = lib.repro_epoch_scan_faults_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = {(False, False): fn, (True, False): fn_dtpm,
               (False, True): fn_faults, (True, True): fn_dtpm_faults,
               "error": err}
    return _fn


def shared_bytes(J: int, A: int, T: int, P: int, C: int = 0,
                 K: int = 0, faults: bool = False) -> int:
    """Dynamic shared memory of one block, a lane (csrc/epoch_scan.cuh's
    layout): its design's tables, then the lane's slice; ``K`` > 0 (with
    ``C``) sizes the DTPM variant, ``faults`` the fail-stop one.  Each part
    is rounded up to 8 bytes."""
    def even(words):
        return words + words % 2
    tables = A * T * P * max(K, 1) + A * T * T + P * P + 2 * A * T + A
    # per lane: group minima and job keys (int64), queues, done masks
    lane = 2 * (-(-J // 32)) + 2 * J + P + J
    if K:
        # the OPP and domain tables; per lane the busy bins (int64), each
        # PE's list head and tail, the OPP indices, RC matrices and carry
        tables += P * K + C * K + 3 * C + 4 * P
        lane += 2 * P + 2 * P + C + 32 + 7
    if faults:
        # fail times, dead and firing PEs, recomputed queues, per-job floor
        # masks
        lane += 4 * P + J
    return 4 * (even(tables) + even(lane))


def kernel_info(J: int, A: int, T: int, P: int, device=None, C: int = 0,
                K: int = 0, faults: bool = False) -> dict:
    """Threads a block, lanes a block, resident lanes an SM, dynamic shared
    bytes, registers a thread and local (stack, spill) bytes a thread of one
    launch at these sizes (``K`` > 0: the DTPM variant; ``faults``: the
    fail-stop one)."""
    lib = _build.load("epoch_scan_faults" if faults else "epoch_scan")
    info_fn = lib.repro_epoch_scan_faults_info if faults else lib.repro_epoch_scan_info
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = info_fn(J, A, T, P, C, K, int(K > 0), out)
    if rc != 0:
        raise RuntimeError(f"epoch_scan info failed: {_kernel()['error'](rc).decode()}")
    info = dict(zip(("threads", "lanes_per_block", "lanes_per_sm",
                     "shared_bytes", "registers", "local_bytes"), out))
    if (info["threads"], info["lanes_per_block"], info["shared_bytes"]) != (
            32, 1, shared_bytes(J, A, T, P, C, K, faults)):
        raise RuntimeError(f"epoch_scan: csrc/epoch_scan.cuh's geometry {info} "
                           "differs from epoch_scan.py's")
    return info


@_metrics.spanned(_metrics.K1)
# lint: waive KL001 -- its inputs are tables, traces and fail times: no grad
def epoch_scan(tables, policy: str, arrival: torch.Tensor,
               app_idx: torch.Tensor, gov=None, faults=None):
    """(L, J) lanes of one table set -> (scheduled, start, finish, onpe), each
    (L, J, T), with ``gov`` (a ``core.dvfs.PolicyLanes`` of L lanes) the
    DTPM program's (onopp, opp_idx, peak_temp_c) after them, and with
    ``faults`` ((L, P) f32 fail times) the fail-stop program's counts (L, 2)
    last.  Over the tables of D stacked designs the lanes are (D*S, J),
    design-major, and the launch is D*S blocks of one warp.  CPU
    tensors take the plain version; CUDA tensors one launch."""
    _check_policy(policy)
    dev = tables.exec_us.device
    if dev.type == "cpu":
        return epoch_scan_plain(tables, policy, arrival, app_idx, gov, faults)
    if dev.type != "cuda":
        raise ValueError(f"epoch_scan: no kernel for device {dev}")
    if arrival.device != dev or app_idx.device != dev:
        raise ValueError(f"epoch_scan: lanes on {arrival.device} / "
                         f"{app_idx.device}, tables on {dev}")
    if arrival.ndim != 2 or app_idx.shape != arrival.shape:
        raise ValueError(f"epoch_scan: arrival {tuple(arrival.shape)}, app_idx "
                         f"{tuple(app_idx.shape)}; both (L, J)")
    L, J = arrival.shape
    A, T, P = tables.exec_us.shape[-3:]
    C, K = tables.opp_freq.shape[-2:] if gov is not None else (0, 0)
    if not 1 <= T <= MAX_TASKS:
        raise ValueError(f"epoch_scan: {T} tasks a job; the kernel takes "
                         f"1..{MAX_TASKS}")
    if L == 0 or J == 0:
        raise ValueError("epoch_scan: no lanes or no jobs")
    S = lanes_per_design(tables, L)
    D = L // S
    if gov is not None:
        _check_dtpm(tables, gov, L)
    if faults is not None:
        faults = _check_faults(faults, policy, L, P)
        if faults.device != dev:
            raise ValueError(f"epoch_scan: fault plans on {faults.device}, "
                             f"tables on {dev}")
    nbytes = shared_bytes(J, A, T, P, C, K, faults is not None)
    if nbytes > MAX_SHARED:
        raise ValueError(f"epoch_scan: {J} jobs of {T} tasks on {P} PEs need "
                         f"{nbytes} bytes of shared memory a block; the card "
                         f"has {MAX_SHARED}")
    # lint: waive TX001 -- a check once a launch: K1 would read out of bounds
    if bool(((app_idx < 0) | (app_idx >= A)).any()):
        raise ValueError(f"epoch_scan: an app index outside 0..{A - 1}")
    prep = _prepare(tables, policy)
    arrival = arrival.to(torch.float32).contiguous()
    app_idx = app_idx.to(torch.int32).contiguous()
    f32 = [t.to(torch.float32).contiguous() for t in
           (tables.exec_us, tables.ebytes, tables.comm_mult,
            tables.comm_startup.reshape(D), tables.comm_inv_bw.reshape(D))]
    table_pe = tables.table_pe.to(torch.int32).contiguous()
    scheduled = torch.empty((L, J, T), dtype=torch.bool, device=dev)
    start = torch.empty((L, J, T), dtype=torch.float32, device=dev)
    finish = torch.empty_like(start)
    onpe = torch.empty((L, J, T), dtype=torch.int32, device=dev)
    static_args = [f32[0], prep["pred_bits"], f32[1], prep["valid_bits"],
                   f32[2], f32[3], f32[4], table_pe, arrival, app_idx,
                   scheduled, start, finish, onpe]
    fns = _kernel()
    fn = fns[gov is not None, faults is not None]
    fault_args, fault_outs, cap = [], (), []
    if faults is not None:
        from ..scenario.faults import fault_scan_steps   # scenario imports core
        # the floor is scratch: a task's is read only once a rollback set it
        fault_outs = (torch.empty((L, 2), dtype=torch.int32, device=dev),)
        fault_args = [faults.contiguous(),
                      torch.empty((L, J, T), dtype=torch.float32, device=dev),
                      fault_outs[0]]
        # lint: waive TX001 -- once a launch: the step cap is a kernel argument
        cap = [fault_scan_steps(J, T, int(torch.isfinite(faults).sum(1).max()))]
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if gov is None:
            rc = fn(*[t.data_ptr() for t in static_args + fault_args], *cap,
                    D, S, J, A, T, P, POLICIES.index(policy), stream)
            outs = ()
        else:
            *dtpm_tables, rc_consts = prep["dtpm"]
            lanes = [gov.window, gov.up, gov.cap,
                     torch.stack([gov.A_rc, gov.B_rc], dim=1),   # (L, 2, 4, 4)
                     quanta(gov.window, lane_p_max(tables, L))]
            lanes = [x.to(dev).contiguous() for x in lanes]
            outs = (torch.empty((L, J, T), dtype=torch.int32, device=dev),
                    torch.empty((L, C), dtype=torch.int32, device=dev),
                    torch.empty((L,), dtype=torch.float32, device=dev))
            # scratch: each committed cell's successor on its PE's list
            next_cell = torch.empty((L, J, T), dtype=torch.int32, device=dev)
            rc = fn(*[t.data_ptr() for t in
                      static_args + dtpm_tables + lanes + [rc_consts]
                      + list(outs) + [next_cell] + fault_args],
                    *cap, D, S, J, A, T, P, POLICIES.index(policy), C, K,
                    stream)
    if rc != 0:
        raise RuntimeError(f"epoch_scan launch failed: {fns['error'](rc).decode()}")
    launches += 1
    variant_launches[gov is not None, faults is not None] += 1
    return (scheduled, start, finish, onpe) + outs + fault_outs
