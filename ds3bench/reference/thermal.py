"""The lumped RC thermal network of the plain reference, in float64.

Nodes [big cluster, LITTLE cluster, accelerator fabric] couple through a
board node to ambient (constants for an Odroid-XU3 class board).  Two peak
temperatures are taken from it:

* under a static governor, the schedule's power is binned into ``bins``
  equal bins of its makespan and held as one period of a sustained
  workload: from the steady state of the period's mean power, ``repeats``
  periods are stepped by the exact linear update, and the peak is the
  hottest node seen (the steady state included);
* under ondemand the simulator steps the network once a sampling window
  (``sim.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .soc import CPU_BIG, CPU_LITTLE, SoC

T_AMBIENT_C = 25.0
NODE_BIG, NODE_LITTLE, NODE_ACCEL = 0, 1, 2
NUM_NODES = 3
R_TO_BOARD = np.array([2.0, 4.0, 3.0])        # K/W
C_NODE = np.array([0.15, 0.05, 0.10])         # J/K
R_BOARD_AMB = 1.5                              # K/W
C_BOARD = 20.0                                 # J/K


def cluster_nodes(soc: SoC) -> np.ndarray:
    return np.asarray([NODE_BIG if pe.pe_type == CPU_BIG else
                       NODE_LITTLE if pe.pe_type == CPU_LITTLE else NODE_ACCEL
                       for pe in soc.pes], np.int64)


def state_matrix() -> np.ndarray:
    """M of dx/dt = M x + u, x = [T_big, T_little, T_accel, T_board]."""
    a = 1.0 / (R_TO_BOARD * C_NODE)
    m = np.zeros((4, 4))
    m[:3, :3] = np.diag(-a)
    m[:3, 3] = a
    m[3, :3] = 1.0 / (R_TO_BOARD * C_BOARD)
    m[3, 3] = -(np.sum(1.0 / R_TO_BOARD) + 1.0 / R_BOARD_AMB) / C_BOARD
    return m


def exact_step_matrices(dt_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """(A, B) of x' = A x + B u over ``dt_s`` seconds of constant power:
    A = exp(M dt), B = M^-1 (A - I)."""
    import scipy.linalg
    m = state_matrix()
    a = scipy.linalg.expm(m * float(dt_s))
    return a, np.linalg.solve(m, a - np.eye(4))


def exact_step(temps: np.ndarray, power_w: np.ndarray, a: np.ndarray,
               b: np.ndarray) -> np.ndarray:
    u = np.concatenate([np.asarray(power_w, np.float64) / C_NODE,
                        [T_AMBIENT_C / (R_BOARD_AMB * C_BOARD)]])
    return a @ temps + b @ u


def steady_state(power_w: np.ndarray) -> np.ndarray:
    tb = T_AMBIENT_C + R_BOARD_AMB * float(np.sum(power_w))
    return np.concatenate([tb + R_TO_BOARD * power_w, [tb]])


def binned_peak(records: Sequence, makespan_us: float,
                node_of_pe: np.ndarray, p_active: np.ndarray,
                p_idle: np.ndarray, bins: int, repeats: int) -> float:
    """Peak temperature of a schedule's power held as one period.
    ``records`` are (job, task, pe, start, finish, ...) rows."""
    dt_us = max(float(makespan_us), 1e-6) / bins
    busy = np.zeros((bins, len(p_active)))
    for r in records:
        pe, s, f = r[2], r[3], r[4]
        k0 = max(int(s // dt_us) - 1, 0)
        k1 = min(int(f // dt_us) + 1, bins - 1)
        for k in range(k0, k1 + 1):
            lo = k * dt_us
            ov = min(f, lo + dt_us) - max(s, lo)
            if ov > 0.0:
                busy[k, pe] += min(ov, dt_us)
    util = np.clip(busy / dt_us, 0.0, 1.0)
    power_pe = p_active * util + p_idle * (1.0 - util)
    power = np.zeros((bins, NUM_NODES))
    for j in range(len(p_active)):
        power[:, node_of_pe[j]] += power_pe[:, j]
    a, b = exact_step_matrices(dt_us * 1e-6)
    temps = steady_state(power.mean(axis=0))
    peak = float(temps[:3].max())
    for i in range(bins * repeats):
        temps = exact_step(temps, power[i % bins], a, b)
        peak = max(peak, float(temps[:3].max()))
    return peak
