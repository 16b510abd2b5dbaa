"""RC thermal co-simulation of a realised schedule, on PyTorch.

The twin of ``src/repro/dse/thermal_jax.py`` (``steady_state``,
``binned_power_trace``, ``peak_temperature``): the same lumped network —
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
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import thermal as _ref


def _const(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def steady_state(power_w: torch.Tensor) -> torch.Tensor:
    """Analytical steady state for constant (3,) node power -> (4,) temps."""
    dev = power_w.device
    tb = _const(_ref.T_AMBIENT_C, dev) + _const(_ref.R_BOARD_AMB, dev) * power_w.sum()
    return torch.cat([tb + _const(_ref.R_TO_BOARD, dev) * power_w, tb[None]])


def binned_power_trace(start_us: torch.Tensor, finish_us: torch.Tensor,
                       onpe: torch.Tensor, valid: torch.Tensor,
                       node_of_pe: torch.Tensor, power_active: torch.Tensor,
                       power_idle: torch.Tensor, makespan_us: torch.Tensor,
                       bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node power trace of one realised schedule.

    Args (one simulation): start/finish/valid (J, T); onpe (J, T) int;
    node_of_pe (P,) int; power_active/power_idle (P,).
    Returns ((bins, 3) node power in W, bin width in seconds).
    """
    P = power_active.shape[0]
    dev = power_active.device
    dt_us = torch.clamp(makespan_us, min=1e-6) / bins
    edges = torch.arange(bins, dtype=torch.float32, device=dev) * dt_us   # (K,)
    s = torch.where(valid, start_us, 0.0)[..., None]                      # (J,T,1)
    f = torch.where(valid, finish_us, 0.0)[..., None]
    overlap = (torch.minimum(f, edges + dt_us)
               - torch.maximum(s, edges))                                 # (J,T,K)
    overlap = torch.minimum(torch.clamp(overlap, min=0.0), dt_us)
    pe_onehot = torch.nn.functional.one_hot(onpe.long(), P).to(torch.float32)
    pe_onehot = pe_onehot * valid[..., None]                              # (J,T,P)
    busy = torch.einsum("jtk,jtp->kp", overlap, pe_onehot)                # (K,P)
    util = torch.clamp(busy / dt_us, 0.0, 1.0)
    power_pe = power_active * util + power_idle * (1.0 - util)            # (K,P)
    node_onehot = torch.nn.functional.one_hot(
        node_of_pe.long(), _ref.NUM_NODES).to(torch.float32)              # (P,3)
    return power_pe @ node_onehot, dt_us * 1e-6


def exact_step_matrices(dt_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) of the exact piecewise-constant update x' = A x + B u, as
    A = Σ e^{λ_j·dt} P_j and B = Σ (e^{λ_j·dt}−1)/λ_j P_j over the host's
    float64 spectral decomposition of the RC matrix (``core.thermal.
    _rc_spectral``), summed in the reference's order."""
    lam, proj = _ref._rc_spectral()
    dev = dt_s.device
    dt = dt_s.to(torch.float32)
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
    """Peak on-chip temperature under a sustained periodic (K, 3) trace.

    Power is constant within a bin, so each bin advances by the exact
    linear-RC solution x' = e^{M·dt} x + M⁻¹(e^{M·dt} − I) u, stable for any
    bin width (bins are makespan/K, so no dt bound can be assumed).
    """
    dev = power_trace_w.device
    power_trace_w = power_trace_w.to(torch.float32)
    A, B = exact_step_matrices(dt_s)
    amb_drive = _const(_ref.T_AMBIENT_C, dev) / (
        _const(_ref.R_BOARD_AMB, dev) * _const(_ref.C_BOARD, dev))
    c_node = _const(_ref.C_NODE, dev)
    t0 = steady_state(power_trace_w.mean(dim=0))
    K = power_trace_w.shape[0]
    temps, peak = t0, t0[:3].max()
    for i in range(K * repeats):
        u = torch.cat([power_trace_w[i % K] / c_node, amb_drive[None]])
        temps = A @ temps + B @ u
        peak = torch.maximum(peak, temps[:3].max())
    return peak
