"""RC thermal co-simulation of a realised schedule, on PyTorch.

The twin of ``src/repro/dse/thermal_jax.py`` (``steady_state``,
``euler_step``, ``transient_trace``, ``binned_power_trace``,
``rc_state_matrix``, ``peak_temperature``, ``peak_temperature_grid``):
the same lumped network —
nodes [big, LITTLE, accel fabric] coupled through a board node to ambient —
in float32 on the schedule's device.  The JAX package computes these with
``jnp`` outside any Pallas kernel; here the single-schedule functions are
plain tensor code and the grid is a hand-written kernel.

Pipeline:
  1. ``binned_power_trace`` — time-bin one realised schedule (start/finish/
     onpe from the epoch scan) into a (K, 3) per-node power trace: active
     power while a PE runs, idle leakage otherwise.
  2. ``peak_temperature`` — treat the trace as one period of a sustained
     workload: warm-start from the analytical steady state of the period-mean
     power, then step a few periods by the exact linear-RC update to capture
     the intra-period ripple.

``peak_temperature_grid`` runs both steps for every lane of a sweep grid
(each lane with its own bin width and RC step), where the reference vmaps
them: on CUDA tensors as K6, one launch of ``csrc/thermal_grid.cu`` (a block
a lane; design notes at its top), on CPU tensors as
``peak_temperature_grid_plain``, the two functions above over chunks of
lanes.  ``run`` takes the same function at one lane, so a sweep lane and its
``run`` share one code path.  Every launch adds one to the registry counter
``thermal_launches`` (``obs.metrics``), which ``run_manifest`` reports.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import thermal as _ref
from ..kernels import _build
from ..obs import metrics as _metrics


def _const(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def steady_state(power_w: torch.Tensor) -> torch.Tensor:
    """Analytical steady state for constant (..., 3) node power -> (..., 4)
    temps."""
    dev = power_w.device
    tb = (_const(_ref.T_AMBIENT_C, dev)
          + _const(_ref.R_BOARD_AMB, dev) * power_w.sum(dim=-1))[..., None]
    return torch.cat([tb + _const(_ref.R_TO_BOARD, dev) * power_w, tb], dim=-1)


def euler_step(temps: torch.Tensor, power_w: torch.Tensor,
               dt_s) -> torch.Tensor:
    """One forward-Euler step on the (..., 4) [nodes..., board] state under
    (..., 3) node power, in the reference's order of operations."""
    dev = temps.device
    dt = _const(dt_s, dev)
    r_to_board, c_node = _const(_ref.R_TO_BOARD, dev), _const(_ref.C_NODE, dev)
    t_node, t_board = temps[..., :3], temps[..., 3:]
    flow = (t_node - t_board) / r_to_board
    t_node = t_node + dt / c_node * (power_w - flow)
    t_board = t_board + dt / _const(_ref.C_BOARD, dev) * (
        flow.sum(dim=-1, keepdim=True)
        - (t_board - _const(_ref.T_AMBIENT_C, dev))
        / _const(_ref.R_BOARD_AMB, dev))
    return torch.cat([t_node, t_board], dim=-1)


def transient_trace(power_trace_w, dt_s, init=None,
                    device="cuda") -> torch.Tensor:
    """Integrate a (K, 3) power trace from ``init`` (default ambient) by
    forward Euler, one step a bin.  Returns (K, 4) temperatures — the twin
    of ``repro.core.thermal.simulate_trace`` and of the reference's
    ``lax.scan``.  ``power_trace_w`` may be numpy; a tensor keeps its own
    device, anything else goes to ``device``."""
    dev = (power_trace_w.device if isinstance(power_trace_w, torch.Tensor)
           else resolve_device(device))
    power = torch.as_tensor(power_trace_w, dtype=torch.float32, device=dev)
    temps = (torch.full((4,), _ref.T_AMBIENT_C, dtype=torch.float32,
                        device=dev) if init is None
             else torch.as_tensor(init, dtype=torch.float32, device=dev))
    out = []
    for k in range(power.shape[0]):
        temps = euler_step(temps, power[k], dt_s)
        out.append(temps)
    return torch.stack(out) if out else power.new_zeros((0, 4))


def rc_state_matrix(device="cuda") -> torch.Tensor:
    """(4, 4) continuous-time state matrix M of the linear RC network in
    float32 on ``device`` — the tensor view of ``core.thermal.
    rc_state_matrix`` (one definition for every integrator)."""
    return torch.as_tensor(_ref.rc_state_matrix(), dtype=torch.float32,
                           device=resolve_device(device))


def binned_power_trace(start_us: torch.Tensor, finish_us: torch.Tensor,
                       onpe: torch.Tensor, valid: torch.Tensor,
                       node_of_pe: torch.Tensor, power_active: torch.Tensor,
                       power_idle: torch.Tensor, makespan_us: torch.Tensor,
                       bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node power trace of realised schedules.

    Args (one simulation, or leading lane axes ``...`` on every argument):
    start/finish/valid (..., J, T); onpe (..., J, T) int; node_of_pe (..., P)
    int; power_active/power_idle (..., P); makespan_us (...).
    Returns ((..., bins, 3) node power in W, (...) bin width in seconds).
    """
    P = power_active.shape[-1]
    dev = power_active.device
    dt_us = torch.clamp(makespan_us, min=1e-6) / bins                    # (...)
    dt = dt_us[..., None, None, None]                                     # (...,1,1,1)
    edges = torch.arange(bins, dtype=torch.float32, device=dev) * dt      # (...,1,1,K)
    s = torch.where(valid, start_us, 0.0)[..., None]                      # (...,J,T,1)
    f = torch.where(valid, finish_us, 0.0)[..., None]
    overlap = (torch.minimum(f, edges + dt)
               - torch.maximum(s, edges))                                 # (...,J,T,K)
    overlap = torch.minimum(torch.clamp(overlap, min=0.0), dt)
    pe_onehot = torch.nn.functional.one_hot(onpe.long(), P).to(torch.float32)
    pe_onehot = pe_onehot * valid[..., None]                              # (...,J,T,P)
    busy = torch.einsum("...jtk,...jtp->...kp", overlap, pe_onehot)      # (...,K,P)
    util = torch.clamp(busy / dt_us[..., None, None], 0.0, 1.0)
    power_pe = (power_active[..., None, :] * util
                + power_idle[..., None, :] * (1.0 - util))                # (...,K,P)
    node_onehot = torch.nn.functional.one_hot(
        node_of_pe.long(), _ref.NUM_NODES).to(torch.float32)              # (...,P,3)
    return power_pe @ node_onehot, dt_us * 1e-6


def exact_step_matrices(dt_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) of the exact piecewise-constant update x' = A x + B u, as
    A = Σ e^{λ_j·dt} P_j and B = Σ (e^{λ_j·dt}−1)/λ_j P_j over the host's
    float64 spectral decomposition of the RC matrix (``core.thermal.
    _rc_spectral``), summed in the reference's order.  ``dt_s`` () or
    (...,) per lane -> (..., 4, 4) each."""
    lam, proj = _ref._rc_spectral()
    dev = dt_s.device
    dt = dt_s.to(torch.float32)[..., None, None]
    A = B = None
    for j in range(len(lam)):
        lam_j = _const(lam[j], dev)
        p_j = _const(proj[j], dev)
        e_j = torch.exp(lam_j * dt)
        a_t = e_j * p_j
        b_t = ((e_j - 1.0) / lam_j) * p_j
        A = a_t if A is None else A + a_t
        B = b_t if B is None else B + b_t
    return A, B


def peak_temperature(power_trace_w: torch.Tensor, dt_s: torch.Tensor,
                     repeats: int = 3) -> torch.Tensor:
    """Peak on-chip temperature under a sustained periodic (..., K, 3)
    trace, ``dt_s`` the bin width () or (...) per lane -> (...).

    Power is constant within a bin, so each bin advances by the exact
    linear-RC solution x' = e^{M·dt} x + M⁻¹(e^{M·dt} − I) u, stable for any
    bin width (bins are makespan/K, so no dt bound can be assumed).
    """
    dev = power_trace_w.device
    power_trace_w = power_trace_w.to(torch.float32)
    A, B = exact_step_matrices(dt_s)                         # (..., 4, 4)
    amb_drive = _const(_ref.T_AMBIENT_C, dev) / (
        _const(_ref.R_BOARD_AMB, dev) * _const(_ref.C_BOARD, dev))
    c_node = _const(_ref.C_NODE, dev)
    t0 = steady_state(power_trace_w.mean(dim=-2))            # (..., 4)
    K = power_trace_w.shape[-2]
    amb = amb_drive.expand(t0.shape[:-1] + (1,))
    temps, peak = t0, t0[..., :3].amax(dim=-1)
    for i in range(K * repeats):
        u = torch.cat([power_trace_w[..., i % K, :] / c_node, amb], dim=-1)
        temps = (A @ temps[..., None] + B @ u[..., None])[..., 0]
        peak = torch.maximum(peak, temps[..., :3].amax(dim=-1))
    return peak


# bytes a chunk of lanes of peak_temperature_grid_plain may take (its
# (lanes, J, T, bins) overlaps and (lanes, J, T, P) one-hots, a few of each)
GRID_CHUNK_BYTES = 1 << 30


def peak_temperature_grid_plain(sim_out: Dict, node_of_pe: torch.Tensor,
                                power_active: torch.Tensor,
                                power_idle: torch.Tensor, bins: int = 32,
                                repeats: int = 3) -> torch.Tensor:
    """:func:`peak_temperature_grid` in plain tensor code, the path of CPU
    tensors: :func:`binned_power_trace` and :func:`peak_temperature` over
    chunks of lanes that keep each chunk's working set near
    ``GRID_CHUNK_BYTES``."""
    makespan = sim_out["makespan_us"]
    lead = tuple(makespan.shape)
    D, S = lead[-2:]
    J, T = sim_out["start"].shape[-2:]
    P = power_active.shape[-1]
    L = makespan.numel()
    if tuple(power_active.shape) != (D, P):
        raise ValueError(f"peak_temperature_grid: power tables "
                         f"{tuple(power_active.shape)} for a {lead} grid")
    flat = {k: sim_out[k].reshape(L, J, T)
            for k in ("start", "finish", "onpe", "scheduled")}
    design = (torch.arange(L, device=makespan.device) // S) % D
    per_lane = 4 * J * T * (4 * bins + 2 * P)
    chunk = max(1, GRID_CHUNK_BYTES // per_lane)
    peaks = []
    for lo in range(0, L, chunk):
        sl, d = slice(lo, lo + chunk), design[lo:lo + chunk]
        trace, dt_s = binned_power_trace(
            flat["start"][sl], flat["finish"][sl], flat["onpe"][sl],
            flat["scheduled"][sl], node_of_pe[d], power_active[d],
            power_idle[d], makespan.reshape(L)[sl], bins=bins)
        peaks.append(peak_temperature(trace, dt_s, repeats=repeats))
    return torch.cat(peaks).reshape(lead)


# K6 (csrc/thermal_grid.cu), loaded at its first launch; its C entry checks
# the grid, P, bins, repeats and shared memory
_fn = None
_consts = None


def rc_constants() -> np.ndarray:
    """The RC network's float32 constants in the kernel's ``Consts`` order:
    the eigenvalues λ_j, the projectors P_j (row-major), R_TO_BOARD, C_NODE,
    T_AMBIENT_C, R_BOARD_AMB, C_BOARD — each rounded once from float64, as
    :func:`exact_step_matrices` and :func:`peak_temperature` round them."""
    global _consts  # host-side memo of constant data, filled once
    if _consts is None:
        lam, proj = _ref._rc_spectral()
        _consts = np.concatenate([
            lam, np.asarray(proj).ravel(), _ref.R_TO_BOARD, _ref.C_NODE,
            [_ref.T_AMBIENT_C, _ref.R_BOARD_AMB, _ref.C_BOARD],
        ]).astype(np.float32)
    return _consts


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("thermal_grid")
        fn = lib.repro_thermal_grid
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p] \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        info = lib.repro_thermal_grid_info
        info.restype = ctypes.c_int
        info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = lib.repro_thermal_grid_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = {"launch": fn, "info": info, "error": err}
    return _fn


def kernel_info(P: int, bins: int, device=None) -> dict:
    """Threads a block, dynamic shared bytes, resident blocks an SM,
    registers a thread and local bytes a thread of K6 at (P, bins)."""
    fns = _kernel()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = fns["info"](P, bins, out)
    _raise_on(rc, f"P {P}, bins {bins}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm", "registers",
                     "local_bytes"), out))


def _raise_on(rc: int, what: str) -> None:
    """The C entry's return code as an exception: ValueError for the
    arguments it refuses (negative codes), RuntimeError for CUDA's."""
    if rc != 0:
        msg = f"peak_temperature_grid: {_kernel()['error'](rc).decode()} ({what})"
        raise ValueError(msg) if rc < 0 else RuntimeError(msg)


@_metrics.spanned(_metrics.THERMAL)
def peak_temperature_grid(sim_out: Dict, node_of_pe: torch.Tensor,
                          power_active: torch.Tensor,
                          power_idle: torch.Tensor, bins: int = 32,
                          repeats: int = 3) -> torch.Tensor:
    """(..., D, S) peak temperatures of a batch of schedules.

    ``sim_out`` has the schedule (``start``, ``finish``, ``onpe``,
    ``scheduled``: (..., D, S, J, T)) and ``makespan_us`` (..., D, S), the
    design axis D second to last (a fault axis may lead, as in the
    reference's vmap over fault lanes); ``node_of_pe`` / ``power_active`` /
    ``power_idle`` are (D, P), each design's.  Every lane gets its own bin
    width and RC step matrices.  CPU tensors take
    :func:`peak_temperature_grid_plain`; CUDA tensors one launch of K6 on
    the current stream, every lane a block (1..32 PEs).
    """
    makespan = sim_out["makespan_us"]
    dev = makespan.device
    if dev.type == "cpu":
        return peak_temperature_grid_plain(sim_out, node_of_pe, power_active,
                                           power_idle, bins, repeats)
    if dev.type != "cuda":
        raise ValueError(f"peak_temperature_grid: no kernel for device {dev}")
    lead = tuple(makespan.shape)
    D, S = lead[-2:]
    J, T = sim_out["start"].shape[-2:]
    P = power_active.shape[-1]
    L = makespan.numel()
    if tuple(power_active.shape) != (D, P) or \
            tuple(power_idle.shape) != (D, P) or \
            tuple(node_of_pe.shape) != (D, P):
        raise ValueError(f"peak_temperature_grid: power tables "
                         f"{tuple(power_active.shape)} for a {lead} grid")
    flat = [sim_out[k].reshape(L, J * T).to(dtype).contiguous()
            for k, dtype in (("start", torch.float32),
                             ("finish", torch.float32),
                             ("onpe", torch.int32),
                             ("scheduled", torch.bool))]
    tables = [node_of_pe.to(torch.int32).contiguous(),
              power_active.to(torch.float32).contiguous(),
              power_idle.to(torch.float32).contiguous()]
    makespan = makespan.reshape(L).to(torch.float32).contiguous()
    if any(t.device != dev for t in flat + tables):
        raise ValueError(f"peak_temperature_grid: the schedule and the power "
                         f"tables must all be on {dev}")
    _build.refuse_grad("thermal_grid", *flat, *tables, makespan)
    peak = torch.empty(lead, dtype=torch.float32, device=dev)
    fns = _kernel()
    consts = rc_constants()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns["launch"](*[t.data_ptr() for t in flat + [makespan] + tables],
                           consts.ctypes.data, consts.size, peak.data_ptr(),
                           L, D, S, J * T, P, bins, repeats, stream)
    _raise_on(rc, f"{L} lanes of a {lead} grid, P {P}, bins {bins}, "
                  f"repeats {repeats}")
    _metrics.counter("thermal_launches").inc()
    return peak
