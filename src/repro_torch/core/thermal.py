"""Lumped RC thermal model (paper §2 — temperature exploration for DTPM).

A small thermal network: one node per cluster (big, LITTLE, accelerator
fabric) plus a board node coupled to ambient.  Forward-Euler integration:

    C_i · dT_i/dt = P_i − (T_i − T_board)/R_i
    C_b · dT_b/dt = Σ_i (T_i − T_board)/R_i − (T_b − T_amb)/R_b

Constants are in the calibrated range for an Odroid-XU3 class board.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

T_AMBIENT_C = 25.0

# node order: [big cluster, LITTLE cluster, accel fabric, board]
NODE_BIG, NODE_LITTLE, NODE_ACCEL = 0, 1, 2
NUM_NODES = 3
R_TO_BOARD = np.array([2.0, 4.0, 3.0], dtype=np.float64)     # K/W
C_NODE = np.array([0.15, 0.05, 0.10], dtype=np.float64)      # J/K
R_BOARD_AMB = 1.5                                            # K/W
C_BOARD = 20.0                                               # J/K


def cluster_nodes(db) -> np.ndarray:
    """Map each PE of a ``ResourceDB`` to its thermal node index.

    big CPUs -> NODE_BIG, LITTLE CPUs -> NODE_LITTLE, accelerators share the
    NODE_ACCEL fabric node.
    """
    from .resources import CPU_BIG, CPU_LITTLE
    out = np.empty(db.num_pes, dtype=np.int64)
    for j, pe in enumerate(db.pes):
        if pe.pe_type == CPU_BIG:
            out[j] = NODE_BIG
        elif pe.pe_type == CPU_LITTLE:
            out[j] = NODE_LITTLE
        else:
            out[j] = NODE_ACCEL
    return out


def node_power_split(db, energy_per_pe_j: np.ndarray,
                     makespan_us: float) -> np.ndarray:
    """Average per-thermal-node power (W) realised by a schedule.

    Replaces any fixed big/LITTLE/accel split assumption: the split is derived
    from the energy each PE actually consumed over the makespan.
    """
    # EnergyReport.energy_per_pe_j stores W·us · 1e-6 = joules — the same
    # convention its avg_power_w is derived with.
    per_pe_w = (np.asarray(energy_per_pe_j, dtype=np.float64)
                / max(float(makespan_us) * 1e-6, 1e-12))
    return np.bincount(cluster_nodes(db), weights=per_pe_w,
                       minlength=NUM_NODES)[:NUM_NODES]


@dataclasses.dataclass
class ThermalState:
    t_node_c: np.ndarray     # (3,) cluster temperatures
    t_board_c: float

    @classmethod
    def ambient(cls) -> "ThermalState":
        return cls(np.full(3, T_AMBIENT_C), T_AMBIENT_C)


def rc_state_matrix() -> np.ndarray:
    """(4, 4) continuous-time state matrix M of the linear RC network.

    dx/dt = M x + u with x = [T_big, T_little, T_accel, T_board] and
    u = [P/C_node..., T_amb/(R_b·C_b)].  Shared by the numpy reference, the
    ``dse.thermal_torch`` pipeline and the DTPM simulation kernels — one
    definition, several integrators.
    """
    a = 1.0 / (R_TO_BOARD * C_NODE)                               # (3,)
    top = np.concatenate([np.diag(-a), a[:, None]], axis=1)       # (3, 4)
    b_in = 1.0 / (R_TO_BOARD * C_BOARD)                           # (3,)
    b_out = -(np.sum(1.0 / R_TO_BOARD) + 1.0 / R_BOARD_AMB) / C_BOARD
    bottom = np.concatenate([b_in, [b_out]])[None]                # (1, 4)
    return np.concatenate([top, bottom], axis=0)


def exact_step_matrices(dt_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """(A, B) of the exact piecewise-constant update x' = A x + B u.

    A = e^{M·dt}, B = M⁻¹(e^{M·dt} − I): unconditionally stable for any step
    width (DESIGN.md §6) — this is the per-window update the DTPM governors'
    thermal-throttle feedback integrates inside both simulation kernels.
    """
    import scipy.linalg
    M = rc_state_matrix()
    A = scipy.linalg.expm(M * float(dt_s))
    B = np.linalg.solve(M, A - np.eye(4))
    return A, B


def exact_step(temps: np.ndarray, power_w: np.ndarray,
               A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Advance the (4,) [nodes..., board] state one window under (3,) power."""
    u = np.concatenate([np.asarray(power_w, np.float64) / C_NODE,
                        [T_AMBIENT_C / (R_BOARD_AMB * C_BOARD)]])
    return A @ np.asarray(temps, np.float64) + B @ u


_RC_SPECTRAL = None


def _rc_spectral():
    """Host-precomputed (float64) spectral decomposition of the constant RC
    state matrix: eigenvalues λ_j and rank-1 projectors P_j = v_j ⊗ w_j with
    M = Σ λ_j P_j.  The RC network is similar to a symmetric matrix (via the
    diagonal capacitance scaling), so the spectrum is real — asserted here.
    """
    global _RC_SPECTRAL  # host-side memo of constant data, filled once
    if _RC_SPECTRAL is None:
        lam, V = np.linalg.eig(rc_state_matrix())
        assert np.abs(lam.imag).max() == 0.0, "RC spectrum must be real"
        proj = np.einsum("ij,jk->jik", V.real, np.linalg.inv(V).real)  # (4,4,4)
        _RC_SPECTRAL = (lam.real, proj)
    return _RC_SPECTRAL


def step(state: ThermalState, power_w: np.ndarray, dt_s: float) -> ThermalState:
    """One forward-Euler step.  ``power_w``: (3,) per-cluster power."""
    flow = (state.t_node_c - state.t_board_c) / R_TO_BOARD
    t_node = state.t_node_c + dt_s / C_NODE * (power_w - flow)
    t_board = state.t_board_c + dt_s / C_BOARD * (
        flow.sum() - (state.t_board_c - T_AMBIENT_C) / R_BOARD_AMB)
    return ThermalState(t_node, float(t_board))


def simulate_trace(power_trace_w: np.ndarray, dt_s: float,
                   init: ThermalState | None = None) -> np.ndarray:
    """Integrate a (steps × 3) cluster power trace; returns (steps × 4) temps."""
    st = init or ThermalState.ambient()
    out = np.zeros((power_trace_w.shape[0], 4), dtype=np.float64)
    for i in range(power_trace_w.shape[0]):
        st = step(st, power_trace_w[i], dt_s)
        out[i, :3] = st.t_node_c
        out[i, 3] = st.t_board_c
    return out


def steady_state(power_w: np.ndarray) -> np.ndarray:
    """Analytical steady-state temps for constant cluster power (sanity oracle)."""
    tb = T_AMBIENT_C + R_BOARD_AMB * float(power_w.sum())
    return np.concatenate([tb + R_TO_BOARD * power_w, [tb]])
