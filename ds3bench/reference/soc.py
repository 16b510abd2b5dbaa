"""The SoC side of the plain reference: PEs, profiled latencies, the
interconnect model, the five reference applications and the mapping of a
design point onto an SoC.

A frozen copy of the simulator's resource database, application DAGs and
design-point mapping (DS3, Arda et al., arXiv:2003.09016, Tables 1-2), in
plain Python and NumPy.  It imports nothing of the program under test, so a
change to the program's tables or DAGs shows as a gap in the benchmark's
comparison instead of moving both sides.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

INF = math.inf

CPU_BIG = "A15"
CPU_LITTLE = "A7"
ACC_SCRAMBLER = "SCR_ACC"
ACC_FFT = "FFT_ACC"
ACC_VITERBI = "VIT_ACC"
CPU_TYPES = (CPU_BIG, CPU_LITTLE)

# DVFS operating points (GHz, V) per CPU cluster (Odroid-XU3)
OPP_TABLE: Dict[str, List[Tuple[float, float]]] = {
    CPU_BIG: [(0.6, 0.90), (1.0, 1.00), (1.4, 1.1), (1.8, 1.2), (2.0, 1.25)],
    CPU_LITTLE: [(0.6, 0.95), (0.8, 1.00), (1.0, 1.05), (1.2, 1.15),
                 (1.4, 1.25)],
}
NOMINAL_FREQ = {CPU_BIG: 2.0, CPU_LITTLE: 1.4}
MAX_OPP_LEVELS = max(len(v) for v in OPP_TABLE.values())

# effective switching capacitance (nF) and leakage (W) per PE type
POWER_COEFF = {
    CPU_BIG: dict(ceff=0.45, leak=0.25),
    CPU_LITTLE: dict(ceff=0.10, leak=0.03),
    ACC_SCRAMBLER: dict(ceff=0.02, leak=0.01),
    ACC_FFT: dict(ceff=0.05, leak=0.02),
    ACC_VITERBI: dict(ceff=0.05, leak=0.02),
}
ACC_POWER_ACTIVE = {ACC_SCRAMBLER: 0.15, ACC_FFT: 0.35, ACC_VITERBI: 0.30}

# profiled task latencies (us): WiFi-TX (paper Table 1) and the other four
# reference applications
PROFILES: Dict[str, Dict[str, float]] = {
    "scrambler_encoder": {ACC_SCRAMBLER: 8, CPU_LITTLE: 22, CPU_BIG: 10},
    "interleaver":       {CPU_LITTLE: 10, CPU_BIG: 4},
    "qpsk_modulation":   {CPU_LITTLE: 15, CPU_BIG: 8},
    "pilot_insertion":   {CPU_LITTLE: 5,  CPU_BIG: 3},
    "inverse_fft":       {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "crc":               {CPU_LITTLE: 5,  CPU_BIG: 3},
    "match_filter":      {CPU_LITTLE: 28, CPU_BIG: 12},
    "payload_extract":   {CPU_LITTLE: 8,  CPU_BIG: 4},
    "fft":               {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "pilot_extract":     {CPU_LITTLE: 6,  CPU_BIG: 3},
    "qpsk_demodulation": {CPU_LITTLE: 18, CPU_BIG: 9},
    "deinterleaver":     {CPU_LITTLE: 12, CPU_BIG: 5},
    "viterbi_decoder":   {ACC_VITERBI: 20, CPU_LITTLE: 520, CPU_BIG: 190},
    "sc_modulation":     {CPU_LITTLE: 10, CPU_BIG: 5},
    "sc_demodulation":   {CPU_LITTLE: 12, CPU_BIG: 6},
    "rrc_filter":        {CPU_LITTLE: 45, CPU_BIG: 18},
    "sync":              {CPU_LITTLE: 30, CPU_BIG: 12},
    "lfm_gen":           {CPU_LITTLE: 14, CPU_BIG: 6},
    "conj_multiply":     {CPU_LITTLE: 24, CPU_BIG: 10},
    "amplitude":         {CPU_LITTLE: 12, CPU_BIG: 5},
    "peak_detect":       {CPU_LITTLE: 8,  CPU_BIG: 4},
    "pd_stack":          {CPU_LITTLE: 10, CPU_BIG: 4},
    "doppler_fft":       {ACC_FFT: 16, CPU_LITTLE: 296, CPU_BIG: 118},
    "cfar":              {CPU_LITTLE: 40, CPU_BIG: 16},
}


@dataclasses.dataclass(frozen=True)
class PE:
    pe_id: int
    pe_type: str
    cluster: int            # DVFS and interconnect domain

    @property
    def is_cpu(self) -> bool:
        return self.pe_type in CPU_TYPES


@dataclasses.dataclass(frozen=True)
class Comm:
    """startup + bytes / bandwidth between two PEs, times the penalty
    across clusters; 0 on the same PE."""
    startup_us: float = 0.5
    bw_bytes_per_us: float = 8_000.0
    cross_cluster_penalty: float = 2.0

    def multiplier(self, src: PE, dst: PE) -> float:
        if src.pe_id == dst.pe_id:
            return 0.0
        return self.cross_cluster_penalty if src.cluster != dst.cluster else 1.0


@dataclasses.dataclass(frozen=True)
class SoC:
    pes: Tuple[PE, ...]
    comm: Comm

    @property
    def num_pes(self) -> int:
        return len(self.pes)

    def base_latency(self, task: str, pe: PE) -> float:
        """Profiled latency at the nominal clock (INF: unsupported)."""
        return PROFILES.get(task, {}).get(pe.pe_type, INF)


def make_soc(num_big: int, num_little: int, num_scr: int, num_fft: int,
             num_vit: int, cross_cluster_penalty: float = 2.0) -> SoC:
    """PEs in the order big, LITTLE, scrambler, FFT, Viterbi; big is
    cluster 0, LITTLE cluster 1, every accelerator cluster 2."""
    kinds = ((CPU_BIG, 0, num_big), (CPU_LITTLE, 1, num_little),
             (ACC_SCRAMBLER, 2, num_scr), (ACC_FFT, 2, num_fft),
             (ACC_VITERBI, 2, num_vit))
    pes: List[PE] = []
    for pe_type, cluster, n in kinds:
        for _ in range(n):
            pes.append(PE(len(pes), pe_type, cluster))
    return SoC(tuple(pes), Comm(cross_cluster_penalty=cross_cluster_penalty))


@dataclasses.dataclass(frozen=True)
class Design:
    """One design point: PE counts, per-cluster frequency caps and the
    cross-cluster penalty (the fields of a configuration file's design)."""
    num_big: int = 4
    num_little: int = 4
    num_scr: int = 2
    num_fft: int = 4
    num_vit: int = 0
    big_freq_ghz: float = 2.0
    little_freq_ghz: float = 1.4
    cross_cluster_penalty: float = 2.0

    def soc(self) -> SoC:
        return make_soc(self.num_big, self.num_little, self.num_scr,
                        self.num_fft, self.num_vit, self.cross_cluster_penalty)

    def freq_caps(self) -> Dict[str, float]:
        return {CPU_BIG: self.big_freq_ghz, CPU_LITTLE: self.little_freq_ghz}


# --------------------------------------------------------------------------
# applications
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    task_id: int
    predecessors: Tuple[int, ...]
    out_bytes: float = 1024.0


@dataclasses.dataclass(frozen=True)
class App:
    name: str
    tasks: Tuple[Task, ...]

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def children(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(c.task_id for c in self.tasks
                           if t.task_id in c.predecessors)
                     for t in self.tasks)


def _chain(name: str, names: Sequence[str], out_bytes: float = 1024.0) -> App:
    return App(name, tuple(Task(n, i, (i - 1,) if i else (), out_bytes)
                           for i, n in enumerate(names)))


def _pulse_doppler() -> App:
    tasks = [Task("pd_stack", 0, (), 4096)]
    tasks += [Task("fft", 1 + i, (0,), 4096) for i in range(4)]
    tasks += [Task("doppler_fft", 5, (1, 2, 3, 4), 4096),
              Task("amplitude", 6, (5,), 2048), Task("cfar", 7, (6,), 1024)]
    return App("pulse_doppler", tuple(tasks))


APPS = {
    "wifi_tx": lambda: _chain("wifi_tx", [
        "scrambler_encoder", "interleaver", "qpsk_modulation",
        "pilot_insertion", "inverse_fft", "crc"]),
    "wifi_rx": lambda: App("wifi_rx", (
        Task("match_filter", 0, (), 2048),
        Task("payload_extract", 1, (0,), 2048),
        Task("fft", 2, (1,), 2048),
        Task("pilot_extract", 3, (2,), 512),
        Task("qpsk_demodulation", 4, (2, 3), 1024),
        Task("deinterleaver", 5, (4,), 1024),
        Task("viterbi_decoder", 6, (5,), 1024))),
    "single_carrier": lambda: App("single_carrier", (
        Task("scrambler_encoder", 0, (), 512),
        Task("sc_modulation", 1, (0,), 512),
        Task("rrc_filter", 2, (1,), 1024),
        Task("sync", 3, (2,), 1024),
        Task("sc_demodulation", 4, (3,), 512),
        Task("crc", 5, (4,), 256))),
    "range_detection": lambda: App("range_detection", (
        Task("lfm_gen", 0, (), 4096),
        Task("fft", 1, (0,), 4096),
        Task("fft", 2, (0,), 4096),
        Task("conj_multiply", 3, (1, 2), 4096),
        Task("inverse_fft", 4, (3,), 4096),
        Task("amplitude", 5, (4,), 2048),
        Task("peak_detect", 6, (5,), 64))),
    "pulse_doppler": _pulse_doppler,
}


def get_app(name: str) -> App:
    return APPS[name]()


def tasks_per_job(app_names: Sequence[str]) -> np.ndarray:
    """(A,) task count of each application, in the list's order."""
    return np.asarray([get_app(n).num_tasks for n in app_names], np.int64)


# --------------------------------------------------------------------------
# power
# --------------------------------------------------------------------------

def opp_voltage(pe_type: str, freq_ghz: float) -> float:
    """Voltage of the lowest OPP at or above ``freq_ghz``."""
    for f, v in OPP_TABLE[pe_type]:
        if f >= freq_ghz - 1e-9:
            return v
    return OPP_TABLE[pe_type][-1][1]


def active_power(pe: PE, freq_ghz: float) -> float:
    """Watts while a PE runs a task: Ceff V^2 f + leakage on a CPU, a fixed
    draw on an accelerator."""
    if pe.is_cpu:
        v = opp_voltage(pe.pe_type, freq_ghz)
        c = POWER_COEFF[pe.pe_type]
        return c["ceff"] * v * v * freq_ghz + c["leak"]
    return ACC_POWER_ACTIVE[pe.pe_type] + POWER_COEFF[pe.pe_type]["leak"]


def idle_power(pe: PE) -> float:
    return POWER_COEFF[pe.pe_type]["leak"]


def capped_levels(pe_type: str,
                  caps: Optional[Mapping[str, float]]) -> List[float]:
    """The OPP ladder of a CPU type up to its cap (never below one level)."""
    opps = [f for f, _ in OPP_TABLE[pe_type]]
    if caps is not None and pe_type in caps:
        opps = [f for f in opps if f <= caps[pe_type] + 1e-9] or opps[:1]
    return opps
