"""Resource database — processing elements and profiled task latencies.

Faithful to the paper (CODES/ISSS'19, Tables 1 & 2): the resource database
holds the list of PEs along with the *expected latency of tasks* profiled on
reference hardware (Odroid-XU3 A7/A15 clusters, Zynq ZCU-102 accelerators).

Latencies are in microseconds.  ``inf`` (absent entry) means the PE cannot
execute that task.  CPU PEs scale latency with a DVFS frequency multiplier;
hardware accelerators run at a fixed clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

INF = math.inf

# --------------------------------------------------------------------------
# PE types
# --------------------------------------------------------------------------

CPU_BIG = "A15"        # ARM big  (Odroid-XU3 Cortex-A15)
CPU_LITTLE = "A7"      # ARM LITTLE (Odroid-XU3 Cortex-A7)
ACC_SCRAMBLER = "SCR_ACC"   # Scrambler-Encoder hardware accelerator
ACC_FFT = "FFT_ACC"         # FFT hardware accelerator
ACC_VITERBI = "VIT_ACC"     # Viterbi decoder accelerator (WiFi-RX)

CPU_TYPES = (CPU_BIG, CPU_LITTLE)

# Nominal DVFS operating points (GHz, Volt) per CPU cluster — Odroid-XU3.
OPP_TABLE: Dict[str, List[Tuple[float, float]]] = {
    CPU_BIG: [(0.6, 0.90), (1.0, 1.00), (1.4, 1.1), (1.8, 1.2), (2.0, 1.25)],
    CPU_LITTLE: [(0.6, 0.95), (0.8, 1.00), (1.0, 1.05), (1.2, 1.15), (1.4, 1.25)],
}
NOMINAL_FREQ = {CPU_BIG: 2.0, CPU_LITTLE: 1.4}

# Effective switching capacitance (nF) + leakage (W) — calibrated after
# Bhat et al., TVLSI'18 power models for the same board.
POWER_COEFF = {
    CPU_BIG: dict(ceff=0.45, leak=0.25),
    CPU_LITTLE: dict(ceff=0.10, leak=0.03),
    ACC_SCRAMBLER: dict(ceff=0.02, leak=0.01),
    ACC_FFT: dict(ceff=0.05, leak=0.02),
    ACC_VITERBI: dict(ceff=0.05, leak=0.02),
}
ACC_POWER_ACTIVE = {ACC_SCRAMBLER: 0.15, ACC_FFT: 0.35, ACC_VITERBI: 0.30}


@dataclasses.dataclass(frozen=True)
class PE:
    """A processing element instance in the SoC."""
    pe_id: int
    pe_type: str            # one of the type names above
    cluster: int            # DVFS / comm domain id
    name: str = ""

    @property
    def is_cpu(self) -> bool:
        return self.pe_type in CPU_TYPES


@dataclasses.dataclass
class CommModel:
    """Analytical on-chip interconnect latency model (paper §2).

    latency(bytes, src, dst) = 0 if same PE;
    startup + bytes/bw, doubled when crossing clusters (bus + memory hop).
    """
    startup_us: float = 0.5
    bw_bytes_per_us: float = 8_000.0     # ~8 GB/s effective on-chip
    cross_cluster_penalty: float = 2.0

    def latency(self, nbytes: float, src: Optional[PE], dst: PE) -> float:
        if src is None or src.pe_id == dst.pe_id:
            return 0.0
        t = self.startup_us + nbytes / self.bw_bytes_per_us
        if src.cluster != dst.cluster:
            t *= self.cross_cluster_penalty
        return t


class ResourceDB:
    """The resource database: PEs + profiled per-task latencies.

    ``profiles`` maps task name -> {pe_type: latency_us}.
    """

    def __init__(self, pes: Sequence[PE], profiles: Mapping[str, Mapping[str, float]],
                 comm: Optional[CommModel] = None):
        self.pes: List[PE] = list(pes)
        self.profiles: Dict[str, Dict[str, float]] = {k: dict(v) for k, v in profiles.items()}
        self.comm = comm or CommModel()

    # -- queries ----------------------------------------------------------
    @property
    def num_pes(self) -> int:
        return len(self.pes)

    def latency(self, task_name: str, pe: PE, freq_scale: float = 1.0) -> float:
        """Expected latency (us) of ``task_name`` on ``pe``.

        ``freq_scale`` = f_nominal / f_current for CPU PEs (DVFS slowdown).
        """
        base = self.profiles.get(task_name, {}).get(pe.pe_type, INF)
        if not pe.is_cpu:
            return base
        return base * freq_scale

    def supports(self, task_name: str, pe: PE) -> bool:
        return self.profiles.get(task_name, {}).get(pe.pe_type, INF) != INF

    def latency_matrix(self, task_names: Sequence[str]):
        """Dense (num_tasks × num_pes) latency table (INF = unsupported)."""
        import numpy as np
        mat = np.full((len(task_names), self.num_pes), np.inf, dtype=np.float32)
        for i, t in enumerate(task_names):
            for j, pe in enumerate(self.pes):
                mat[i, j] = self.profiles.get(t, {}).get(pe.pe_type, INF)
        return mat

    def pes_of_type(self, pe_type: str) -> List[PE]:
        return [p for p in self.pes if p.pe_type == pe_type]


# --------------------------------------------------------------------------
# Paper Table 1 — WiFi-TX execution profiles (us) on Odroid A7/A15 + accs.
# --------------------------------------------------------------------------
WIFI_TX_PROFILES: Dict[str, Dict[str, float]] = {
    "scrambler_encoder": {ACC_SCRAMBLER: 8, CPU_LITTLE: 22, CPU_BIG: 10},
    "interleaver":       {CPU_LITTLE: 10, CPU_BIG: 4},
    "qpsk_modulation":   {CPU_LITTLE: 15, CPU_BIG: 8},
    "pilot_insertion":   {CPU_LITTLE: 5,  CPU_BIG: 3},
    "inverse_fft":       {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "crc":               {CPU_LITTLE: 5,  CPU_BIG: 3},
}

# Representative profiles for the other four reference applications
# (WiFi-RX, single-carrier low-power, range detection, pulse Doppler), in the
# style of the released DS3 benchmark suite (Zynq/Odroid profiled).
EXTRA_PROFILES: Dict[str, Dict[str, float]] = {
    # WiFi-RX
    "match_filter":      {CPU_LITTLE: 28, CPU_BIG: 12},
    "payload_extract":   {CPU_LITTLE: 8,  CPU_BIG: 4},
    "fft":               {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "pilot_extract":     {CPU_LITTLE: 6,  CPU_BIG: 3},
    "qpsk_demodulation": {CPU_LITTLE: 18, CPU_BIG: 9},
    "deinterleaver":     {CPU_LITTLE: 12, CPU_BIG: 5},
    "viterbi_decoder":   {ACC_VITERBI: 20, CPU_LITTLE: 520, CPU_BIG: 190},
    # Single-carrier (low-power) TX/RX
    "sc_modulation":     {CPU_LITTLE: 10, CPU_BIG: 5},
    "sc_demodulation":   {CPU_LITTLE: 12, CPU_BIG: 6},
    "rrc_filter":        {CPU_LITTLE: 45, CPU_BIG: 18},
    "sync":              {CPU_LITTLE: 30, CPU_BIG: 12},
    # Range detection (LFM correlation)
    "lfm_gen":           {CPU_LITTLE: 14, CPU_BIG: 6},
    "conj_multiply":     {CPU_LITTLE: 24, CPU_BIG: 10},
    "amplitude":         {CPU_LITTLE: 12, CPU_BIG: 5},
    "peak_detect":       {CPU_LITTLE: 8,  CPU_BIG: 4},
    # Pulse Doppler
    "pd_stack":          {CPU_LITTLE: 10, CPU_BIG: 4},
    "doppler_fft":       {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "cfar":              {CPU_LITTLE: 40, CPU_BIG: 16},
}

ALL_PROFILES: Dict[str, Dict[str, float]] = {**WIFI_TX_PROFILES, **EXTRA_PROFILES}


def make_soc_table2(with_viterbi: bool = False) -> ResourceDB:
    """SoC configuration of paper Table 2.

    4× Cortex-A15 (big), 4× Cortex-A7 (LITTLE), 2× Scrambler-Encoder
    accelerators, 4× FFT accelerators  — 14 PEs total.
    """
    pes: List[PE] = []
    idx = 0
    for i in range(4):
        pes.append(PE(idx, CPU_BIG, cluster=0, name=f"A15-{i}")); idx += 1
    for i in range(4):
        pes.append(PE(idx, CPU_LITTLE, cluster=1, name=f"A7-{i}")); idx += 1
    for i in range(2):
        pes.append(PE(idx, ACC_SCRAMBLER, cluster=2, name=f"SCR-{i}")); idx += 1
    for i in range(4):
        pes.append(PE(idx, ACC_FFT, cluster=2, name=f"FFT-{i}")); idx += 1
    if with_viterbi:
        pes.append(PE(idx, ACC_VITERBI, cluster=2, name="VIT-0")); idx += 1
    return ResourceDB(pes, ALL_PROFILES)


def make_soc(num_big: int = 4, num_little: int = 4, num_scr: int = 2,
             num_fft: int = 4, num_vit: int = 0,
             profiles: Optional[Mapping[str, Mapping[str, float]]] = None,
             comm: Optional[CommModel] = None) -> ResourceDB:
    """Arbitrary SoC configuration for design-space exploration.

    ``comm`` overrides the interconnect model (e.g. a different cross-cluster
    penalty per design point); cluster-frequency caps are applied when the
    simulation tables are built (``build_tables`` + a userspace governor).
    """
    pes: List[PE] = []
    idx = 0
    for i in range(num_big):
        pes.append(PE(idx, CPU_BIG, 0, f"A15-{i}")); idx += 1
    for i in range(num_little):
        pes.append(PE(idx, CPU_LITTLE, 1, f"A7-{i}")); idx += 1
    for i in range(num_scr):
        pes.append(PE(idx, ACC_SCRAMBLER, 2, f"SCR-{i}")); idx += 1
    for i in range(num_fft):
        pes.append(PE(idx, ACC_FFT, 2, f"FFT-{i}")); idx += 1
    for i in range(num_vit):
        pes.append(PE(idx, ACC_VITERBI, 2, f"VIT-{i}")); idx += 1
    return ResourceDB(pes, dict(profiles) if profiles else ALL_PROFILES,
                      comm=comm)
