"""DAG application models — the five reference applications of the paper.

An application is a directed acyclic graph of named tasks (paper Fig. 2 shows
WiFi-TX).  Each edge carries a payload size (bytes) used by the analytical
interconnect model.  Task latencies live in the resource database
(``resources.ALL_PROFILES``), keyed by task name.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    task_id: int                       # index within the application DAG
    predecessors: Tuple[int, ...]      # task_ids of parents
    out_bytes: float = 1024.0          # payload produced for each successor


@dataclasses.dataclass(frozen=True)
class Application:
    """A DAG application (one *job* = one instance of an application)."""
    name: str
    tasks: Tuple[Task, ...]

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def task_names(self) -> List[str]:
        return [t.name for t in self.tasks]

    def pred_matrix(self) -> np.ndarray:
        """(T × T) bool: pred_matrix[i, j] = task j is a predecessor of i."""
        m = np.zeros((self.num_tasks, self.num_tasks), dtype=bool)
        for t in self.tasks:
            for p in t.predecessors:
                m[t.task_id, p] = True
        return m

    def edge_bytes_matrix(self) -> np.ndarray:
        """(T × T) float: bytes flowing j -> i (0 when no edge)."""
        m = np.zeros((self.num_tasks, self.num_tasks), dtype=np.float32)
        for t in self.tasks:
            for p in t.predecessors:
                m[t.task_id, p] = self.tasks[p].out_bytes
        return m

    def validate(self) -> None:
        for t in self.tasks:
            assert all(p < t.task_id for p in t.predecessors), \
                f"{self.name}: tasks must be topologically ordered"


def _chain(name: str, task_names: Sequence[str], out_bytes: float = 1024.0) -> Application:
    tasks = tuple(
        Task(n, i, (i - 1,) if i > 0 else (), out_bytes)
        for i, n in enumerate(task_names)
    )
    app = Application(name, tasks)
    app.validate()
    return app


# --------------------------------------------------------------------------
# The five reference applications (wireless communication + radar domains)
# --------------------------------------------------------------------------

def wifi_tx() -> Application:
    """Paper Fig. 2: WiFi transmitter pipeline."""
    return _chain("wifi_tx", [
        "scrambler_encoder", "interleaver", "qpsk_modulation",
        "pilot_insertion", "inverse_fft", "crc",
    ])


def wifi_rx() -> Application:
    """WiFi receiver: two front-end branches joining at the demodulator."""
    t = [
        Task("match_filter",      0, (), 2048),
        Task("payload_extract",   1, (0,), 2048),
        Task("fft",               2, (1,), 2048),
        Task("pilot_extract",     3, (2,), 512),
        Task("qpsk_demodulation", 4, (2, 3), 1024),
        Task("deinterleaver",     5, (4,), 1024),
        Task("viterbi_decoder",   6, (5,), 1024),
    ]
    app = Application("wifi_rx", tuple(t))
    app.validate()
    return app


def single_carrier() -> Application:
    """Low-power single-carrier TX/RX loop."""
    t = [
        Task("scrambler_encoder", 0, (), 512),
        Task("sc_modulation",     1, (0,), 512),
        Task("rrc_filter",        2, (1,), 1024),
        Task("sync",              3, (2,), 1024),
        Task("sc_demodulation",   4, (3,), 512),
        Task("crc",               5, (4,), 256),
    ]
    app = Application("single_carrier", tuple(t))
    app.validate()
    return app


def range_detection() -> Application:
    """Radar range detection: parallel FFT of reference & received chirps."""
    t = [
        Task("lfm_gen",       0, (), 4096),
        Task("fft",           1, (0,), 4096),    # FFT(reference)
        Task("fft",           2, (0,), 4096),    # FFT(received)
        Task("conj_multiply", 3, (1, 2), 4096),
        Task("inverse_fft",   4, (3,), 4096),
        Task("amplitude",     5, (4,), 2048),
        Task("peak_detect",   6, (5,), 64),
    ]
    app = Application("range_detection", tuple(t))
    app.validate()
    return app


def pulse_doppler() -> Application:
    """Pulse-Doppler radar: a bank of parallel FFTs, then Doppler processing."""
    nfft = 4
    tasks: List[Task] = [Task("pd_stack", 0, (), 4096)]
    for i in range(nfft):
        tasks.append(Task("fft", 1 + i, (0,), 4096))
    join = 1 + nfft
    tasks.append(Task("doppler_fft", join, tuple(range(1, 1 + nfft)), 4096))
    tasks.append(Task("amplitude", join + 1, (join,), 2048))
    tasks.append(Task("cfar", join + 2, (join + 1,), 1024))
    app = Application("pulse_doppler", tuple(tasks))
    app.validate()
    return app


REFERENCE_APPS = {
    "wifi_tx": wifi_tx,
    "wifi_rx": wifi_rx,
    "single_carrier": single_carrier,
    "range_detection": range_detection,
    "pulse_doppler": pulse_doppler,
}


def get_application(name: str) -> Application:
    try:
        return REFERENCE_APPS[name]()
    except KeyError:
        raise KeyError(f"unknown application {name!r}; have {sorted(REFERENCE_APPS)}")
