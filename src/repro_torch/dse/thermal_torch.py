"""RC thermal co-simulation of a realised schedule, on PyTorch.

The twin of ``src/repro/dse/thermal_jax.py`` (``steady_state``,
``euler_step``, ``transient_trace``, ``binned_power_trace``,
``rc_state_matrix``, ``peak_temperature``, ``peak_temperature_grid``):
the same lumped network —
nodes [big, LITTLE, accel fabric] coupled through a board node to ambient —
in float32 on the schedule's device.  Plain tensor code: the JAX package
computes these with ``jnp`` outside any Pallas kernel.

Pipeline:
  1. ``binned_power_trace`` — time-bin one realised schedule (start/finish/
     onpe from the epoch scan) into a (K, 3) per-node power trace: active
     power while a PE runs, idle leakage otherwise.
  2. ``peak_temperature`` — treat the trace as one period of a sustained
     workload: warm-start from the analytical steady state of the period-mean
     power, then step a few periods by the exact linear-RC update to capture
     the intra-period ripple.

Each function also takes leading lane axes (one schedule per lane, each
with its own bin width and RC step): ``peak_temperature_grid`` runs both
steps for a whole sweep grid at once, in chunks of lanes, where the
reference vmaps them.  ``run`` takes the same function at one lane, so a
sweep lane and its ``run`` share one code path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import resolve_device
from ..core import thermal as _ref
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


# device bytes a chunk of lanes of peak_temperature_grid may take (its
# (lanes, J, T, bins) overlaps and (lanes, J, T, P) one-hots, a few of each)
GRID_CHUNK_BYTES = 1 << 30


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
    width and RC step matrices; lanes run in chunks that keep each chunk's
    working set near ``GRID_CHUNK_BYTES``.
    """
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
