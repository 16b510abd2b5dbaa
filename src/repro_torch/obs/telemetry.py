"""Per-sampling-window telemetry timelines, on the port.

The twin of ``src/repro/obs/telemetry.py``.  A :class:`Telemetry` holds
``(W, C)`` numpy arrays — one row per sampling window, one column per
frequency domain (cluster) — of the quantities the DTPM loop integrates:
OPP/frequency, utilisation, realised node power and RC node temperatures.
Its dict form carries the reference's schema tag, so a file written by
either package renders in either report.  Three producers:

* **ref, dynamic governor** — a :class:`TelemetryRecorder` passed to
  ``core.simkernel_ref.simulate(..., telemetry=rec)`` records each window
  in-loop (the exact values the governor feedback saw);
* **torch, dynamic governor** — :func:`torch_dtpm_telemetry` replays the
  plain scan's window step (``kernels.epoch_scan._Windows``) against the
  *final* schedule of one K1 launch, every lane of it at once.  A window
  closes only once no later commit can overlap it (``start ≥ data_ready ≥
  epoch ≥ window end``), and a later commit adds an exact 0 to the window's
  fixed-point sums, so the replay is value-identical to the scan's carry:
  the replayed peak equals K1's ``peak_temp_c`` bit for bit, and K1 runs as
  it does without telemetry;
* **static governors** — the same window observables at the governor's
  fixed OPP: :func:`ref_static_telemetry` (numpy, over the event-heap
  records) and :func:`torch_static_telemetry` (over K1's outputs, lanes
  batched, the sums in the same exact fixed point).

Both torch replays keep every lane of a launch on the batch axis, loop to
the largest window count with a lane's window masked once its own count is
reached, and copy their outputs to the host once, at the end.  The
reference's ``_bucket_pow2`` (a jit-cache bucket for the window axis) has no
twin: nothing here is compiled per shape.  Each replay is timed, to its last
copy to the host, by the ``obs.telemetry.replay`` timer of the
``obs.metrics`` registry; ``obs.telemetry.window_steps`` counts the windows
it looped over (its largest lane's) and ``obs.telemetry.lane_windows`` the
windows of all its lanes.

Sizes: ``W = ceil(makespan / window)`` (windows whose *start* precedes the
makespan — both kernels' tail drain); ``C`` is the domain count
(``core.simkernel_torch.MIN_DOMAINS`` floor, accel fabric last: zero
utilisation, zero frequency).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import thermal as _thermal
from ..core.dvfs import capped_levels, policy_lanes
from ..core.power import active_power, idle_power
from ..core.resources import ResourceDB
from ..kernels import epoch_scan as _k1
from . import metrics as _metrics

TELEMETRY_SCHEMA = "repro.obs/telemetry/v1"

#: default sampling window for *static*-governor telemetry, where no governor
#: window exists to inherit (matches OndemandGovernor's default)
DEFAULT_WINDOW_US = 50.0

# the torch replays' wall time and the windows they replayed
replay_timer = _metrics.timer("obs.telemetry.replay")
window_steps = _metrics.counter("obs.telemetry.window_steps")
lane_windows = _metrics.counter("obs.telemetry.lane_windows")


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Per-window timelines.  All arrays have ``W`` rows (sampling windows,
    window ``w`` covering ``[w·window_us, (w+1)·window_us)``)."""
    window_us: float
    freq_idx: np.ndarray      # (W, C) i32 — OPP index per domain (post-clamp)
    freq_ghz: np.ndarray      # (W, C) f32 — frequency per domain (0 = accel)
    util: np.ndarray          # (W, C) f32 — CPU utilisation per domain
    power_w: np.ndarray       # (W, 3) f32 — realised power per thermal node
    temps_c: np.ndarray       # (W, 4) f32 — RC node temps at window end

    @property
    def num_windows(self) -> int:
        return int(self.freq_idx.shape[0])

    @property
    def num_domains(self) -> int:
        return int(self.freq_idx.shape[1])

    @property
    def time_us(self) -> np.ndarray:
        """Window-end timestamps, (W,)."""
        return (np.arange(self.num_windows, dtype=np.float64) + 1.0) \
            * self.window_us

    @property
    def peak_temp_c(self) -> float:
        """Peak on-chip (non-board) temperature over the timeline."""
        if self.temps_c.size == 0:
            return float(_thermal.T_AMBIENT_C)
        return float(np.max(self.temps_c[:, :3]))

    @property
    def avg_power_w(self) -> float:
        """Mean total (all-node) power over the timeline."""
        if self.power_w.size == 0:
            return 0.0
        return float(np.mean(np.sum(self.power_w, axis=1)))

    def to_dict(self) -> Dict:
        """JSON-ready form (schema-tagged; inverse of :meth:`from_dict`)."""
        return {
            "schema": TELEMETRY_SCHEMA,
            "window_us": float(self.window_us),
            "freq_idx": self.freq_idx.astype(int).tolist(),
            "freq_ghz": np.asarray(self.freq_ghz, np.float64).tolist(),
            "util": np.asarray(self.util, np.float64).tolist(),
            "power_w": np.asarray(self.power_w, np.float64).tolist(),
            "temps_c": np.asarray(self.temps_c, np.float64).tolist(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Telemetry":
        if d.get("schema") != TELEMETRY_SCHEMA:
            raise ValueError(f"not a telemetry dict: schema={d.get('schema')!r}")
        return cls(
            window_us=float(d["window_us"]),
            freq_idx=np.asarray(d["freq_idx"], np.int32),
            freq_ghz=np.asarray(d["freq_ghz"], np.float32),
            util=np.asarray(d["util"], np.float32),
            power_w=np.asarray(d["power_w"], np.float32),
            temps_c=np.asarray(d["temps_c"], np.float32),
        )

    def equals(self, other: "Telemetry") -> bool:
        """Bit for bit: the same window and the same arrays, dtypes
        included."""
        return self.window_us == other.window_us and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in ((getattr(self, f), getattr(other, f))
                         for f in ("freq_idx", "freq_ghz", "util", "power_w",
                                   "temps_c")))


class TelemetryRecorder:
    """In-loop per-window recorder for the reference kernel.

    ``simulate(..., telemetry=rec)`` calls :meth:`on_window` once per closed
    sampling window (in order); :meth:`build` assembles the ``(W, C)``
    :class:`Telemetry`, padding domains the SoC doesn't populate (the accel
    fabric column) with zeros.
    """

    def __init__(self, window_us: float):
        self.window_us = float(window_us)
        self._rows: List[Dict] = []

    def on_window(self, w_end_us: float, util: Dict[int, float],
                  freq_ghz: Dict[int, float], freq_idx: Dict[int, int],
                  node_power_w: np.ndarray, temps_c: np.ndarray) -> None:
        self._rows.append(dict(
            w_end_us=float(w_end_us),
            util=dict(util), freq_ghz=dict(freq_ghz),
            freq_idx=dict(freq_idx),
            power_w=np.asarray(node_power_w, np.float32).copy(),
            temps_c=np.asarray(temps_c, np.float32).copy(),
        ))

    def build(self, num_domains: int) -> Telemetry:
        W, C = len(self._rows), int(num_domains)
        freq_idx = np.zeros((W, C), np.int32)
        freq_ghz = np.zeros((W, C), np.float32)
        util = np.zeros((W, C), np.float32)
        power_w = np.zeros((W, _thermal.NUM_NODES), np.float32)
        temps_c = np.full((W, 4), _thermal.T_AMBIENT_C, np.float32)
        for w, row in enumerate(self._rows):
            for c, v in row["util"].items():
                util[w, c] = v
            for c, v in row["freq_ghz"].items():
                freq_ghz[w, c] = v
            for c, v in row["freq_idx"].items():
                freq_idx[w, c] = v
            power_w[w] = row["power_w"]
            temps_c[w] = row["temps_c"]
        return Telemetry(self.window_us, freq_idx, freq_ghz, util,
                         power_w, temps_c)


# --------------------------------------------------------------------------
# Shared sizing / frequency-column helpers
# --------------------------------------------------------------------------

def num_windows_for(makespan_us: float, window_us: float) -> int:
    """Windows whose start precedes the makespan (both kernels' drain)."""
    if makespan_us <= 0.0 or window_us <= 0.0:
        return 0
    return int(math.ceil(makespan_us / window_us - 1e-9))


def domain_count(db: ResourceDB) -> int:
    """Frequency-domain count for ``db`` (matches ``build_tables``)."""
    from ..core.simkernel_torch import MIN_DOMAINS
    return max(MIN_DOMAINS, max(pe.cluster for pe in db.pes) + 1)


def static_freq_columns(db: ResourceDB, governor, num_domains: int):
    """``(freq_ghz, freq_idx)`` rows, each ``(C,)``, for a *static* governor:
    one fixed entry per CPU cluster (nearest capped-ladder level), zeros for
    the accel domain.  Constants of the governor — shared by both backends so
    the ref↔torch telemetry comparison is exact by construction."""
    caps = getattr(governor, "freq_caps", None)
    freq_ghz = np.zeros(num_domains, np.float32)
    freq_idx = np.zeros(num_domains, np.int32)
    seen = set()
    for pe in db.pes:
        if not pe.is_cpu or pe.cluster in seen:
            continue
        seen.add(pe.cluster)
        f = governor.initial_freq(pe.pe_type)
        opps = capped_levels(pe.pe_type, caps)
        k = min(range(len(opps)), key=lambda i: abs(opps[i] - f))
        freq_ghz[pe.cluster] = opps[k]
        freq_idx[pe.cluster] = k
    return freq_ghz, freq_idx


def static_window(governor) -> float:
    """The sampling window of a static governor's telemetry: its own, where
    it has one, else :data:`DEFAULT_WINDOW_US`."""
    return float(getattr(governor, "sample_window_us", None)
                 or DEFAULT_WINDOW_US)


def _empty(window_us: float, C: int) -> Telemetry:
    return Telemetry(window_us,
                     np.zeros((0, C), np.int32), np.zeros((0, C), np.float32),
                     np.zeros((0, C), np.float32),
                     np.zeros((0, _thermal.NUM_NODES), np.float32),
                     np.zeros((0, 4), np.float32))


# --------------------------------------------------------------------------
# Torch replays over one K1 launch's outputs, lanes batched
# --------------------------------------------------------------------------

def _lane_cells(tables, out: Dict, app_idx, L: int):
    """The (L, J*T) cells of the lanes' final schedules on the tables'
    device: committed (scheduled and valid), start, finish, PE; and each
    lane's design (its index into a stack)."""
    dev = tables.exec_us.device
    design = _k1.lane_designs(tables, L, dev)
    app = torch.as_tensor(app_idx).to(dev, torch.long)
    valid = _k1.per_design(tables, "valid")[design[:, None], app]   # (L, J, T)
    committed = (out["scheduled"] & valid).reshape(L, -1)
    return (design, committed, out["start"].reshape(L, -1),
            out["finish"].reshape(L, -1), out["onpe"].reshape(L, -1).long())


def _timed(fn):
    """``fn`` inside :data:`replay_timer` (its outputs end on the host, so
    the interval covers the device's work)."""
    @functools.wraps(fn)
    def call(*args, **kw):
        with replay_timer:
            return fn(*args, **kw)
    return call


def _window_counts(out: Dict, windows: Sequence[float]) -> List[int]:
    """Each lane's W, from its makespan (one copy to the host), counted in
    the registry."""
    counts = [num_windows_for(m, w) for m, w in
              zip(out["makespan_us"].reshape(-1).tolist(), windows)]
    window_steps.inc(max(counts, default=0))
    lane_windows.inc(sum(counts))
    return counts


@_timed
def torch_dtpm_telemetry(tables, gov, out: Dict, app_idx) -> List[Telemetry]:
    """Telemetry of every lane of one DTPM epoch scan, one replay for all.

    ``tables``: one design's or a stack (lanes design-major, as K1 reads
    them); ``gov``: the launch's ``PolicyLanes`` (or one dynamic
    ``GovernorPolicy`` / a sequence of L, as ``simulate_batch_dtpm`` takes);
    ``out``: the scan's ``scheduled``, ``start``, ``finish``, ``onpe``,
    ``onopp`` (L, J, T) and ``makespan_us`` (L,) on the tables' device;
    ``app_idx`` (L, J).  The replay drives the plain scan's window step with
    the scan's own policies and fixed-point exponents, so each lane's
    temperatures, and their peak, are the ones K1's carry went through.
    Returns L :class:`Telemetry` in lane order; a lane's window is its
    policy's, as f32 (what the scan ran).
    """
    L = int(out["start"].shape[0])
    lanes = policy_lanes(gov, L)
    design, committed, start, finish, onpe = _lane_cells(tables, out,
                                                         app_idx, L)
    onopp = out["onopp"].reshape(L, -1).long()
    dev = committed.device
    windows = lanes.window.tolist()
    counts = _window_counts(out, windows)
    W = max(counts, default=0)
    C = int(tables.opp_freq.shape[-2])
    win = _k1._Windows(tables, lanes, design, dev)
    freq_idx = torch.zeros((W, L, C), dtype=torch.int32, device=dev)
    util = torch.zeros((W, L, C), dtype=torch.float32, device=dev)
    power = torch.zeros((W, L, _thermal.NUM_NODES), dtype=torch.float32,
                        device=dev)
    temps = torch.zeros((W, L, 4), dtype=torch.float32, device=dev)
    last = torch.tensor(counts, device=dev)
    for w in range(W):
        util[w], power[w] = win.step(last > w, committed, start, finish,
                                     onpe, onopp)
        freq_idx[w] = win.opp_idx
        temps[w] = win.temps
    freq_idx, util, power, temps = (x.cpu().numpy() for x in
                                    (freq_idx, util, power, temps))
    opp_freq = _k1.per_design(tables, "opp_freq")[design].cpu().numpy()
    tels = []
    for lane, (n, window) in enumerate(zip(counts, windows)):
        if n == 0:
            tels.append(_empty(window, C))
            continue
        idx = freq_idx[:n, lane]
        ghz = np.take_along_axis(opp_freq[lane][None], idx[:, :, None],
                                 axis=2)[..., 0]
        tels.append(Telemetry(window, idx, ghz.astype(np.float32),
                              util[:n, lane], power[:n, lane],
                              temps[:n, lane]))
    return tels


@_timed
def torch_static_telemetry(tables, out: Dict, app_idx,
                           freq_columns: Sequence,
                           window_us=DEFAULT_WINDOW_US) -> List[Telemetry]:
    """Telemetry of every lane of one static epoch scan, one replay for all:
    the window observables at the tables' fixed OPP, as the reference's
    ``_telemetry_scan_static`` (``simkernel_jax.py:711``) computes them.

    ``tables``, ``out`` (``scheduled``, ``start``, ``finish``, ``onpe``
    (L, J, T), ``makespan_us`` (L,)) and ``app_idx`` (L, J) as
    :func:`torch_dtpm_telemetry`'s; ``freq_columns``: one ``(freq_ghz,
    freq_idx)`` pair of :func:`static_freq_columns` per design of the tables
    (one for one design's), each of its design's domain count;
    ``window_us``: one window for every design, or one per design.  Window
    ``w`` covers ``[w·window, w·window + window)`` in f32, as the reference;
    its per-PE and per-domain sums are exact fixed-point sums (as the DTPM
    window's), the node power a fixed tree, the RC step (dt = window, from
    the host's spectral matrices) a left-to-right sum of rounded products,
    so the card and the CPU give the same bits.
    """
    from ..dse.thermal_torch import exact_step_matrices
    L = int(out["start"].shape[0])
    design, committed, start, finish, onpe = _lane_cells(tables, out,
                                                         app_idx, L)
    dev = committed.device
    D = max(_k1.designs(tables), 1)
    if len(freq_columns) != D:
        raise ValueError(f"{len(freq_columns)} frequency columns for {D} "
                         "designs")
    per_d = ([float(window_us)] * D if np.ndim(window_us) == 0
             else [float(w) for w in window_us])
    lane_d = design.tolist()
    windows = [per_d[d] for d in lane_d]
    counts = _window_counts(out, windows)
    W = max(counts, default=0)
    C = max(len(f) for f, _ in freq_columns)
    P = tables.num_pes

    def lane(name):
        return _k1.per_design(tables, name)[design]                 # (L, ...)
    p_act = lane("power_active")
    p_cell = p_act.gather(1, onpe)                                  # (L, N)
    p_max = _k1.per_design(tables, "power_active").amax(1).tolist()
    window_h = torch.tensor(windows, dtype=torch.float32)
    scales, backs = _k1.window_scales(window_h, [p_max[d] for d in lane_d],
                                      dev)
    cpu_dom = _k1.cpu_domains(lane("pe_domain"), lane("pe_is_cpu"), C)
    domain_cpu = cpu_dom.sum(dim=1).float()                         # (L, C)
    mask = _k1.node_mask(lane("node_of_pe"),
                         max(_k1.MAX_PES_DTPM, 1 << (P - 1).bit_length()))
    rc = torch.from_numpy(_k1.rc_consts()).to(dev)
    c_node, amb_drive = rc[:3], rc[3:4]
    A, B = (m.to(dev) for m in exact_step_matrices(window_h * 1e-6))
    floor = torch.tensor(np.float32(1e-9), device=dev)
    power_idle = lane("power_idle")
    window = window_h.to(dev)[:, None]                              # (L, 1)
    w_f = torch.zeros((L, 1), dtype=torch.float32, device=dev)
    carry = torch.full((L, 4), float(rc[4]), device=dev)
    util = torch.zeros((W, L, C), dtype=torch.float32, device=dev)
    power = torch.zeros((W, L, _thermal.NUM_NODES), dtype=torch.float32,
                        device=dev)
    temps = torch.zeros((W, L, 4), dtype=torch.float32, device=dev)
    for w in range(W):
        w0 = w_f * window
        w1 = w0 + window
        ov = torch.minimum(torch.clamp(torch.minimum(finish, w1)
                                       - torch.maximum(start, w0), min=0.0),
                           window)
        ov = torch.where(committed, ov, 0.0)
        busy_pe, e_act, busy_dom = _k1.window_sums(ov, p_cell, onpe, scales,
                                                   backs, cpu_dom, P)
        util[w] = busy_dom / torch.maximum(window * domain_cpu, floor)
        idle_frac = 1.0 - torch.clamp(busy_pe / window, 0.0, 1.0)
        p_pe = e_act / window + power_idle * idle_frac
        power[w] = _k1.node_power(p_pe, mask)
        carry = _k1.rc_step(A, B, carry, power[w], c_node, amb_drive)
        temps[w] = carry
        w_f = w_f + 1.0
    util, power, temps = (x.cpu().numpy() for x in (util, power, temps))
    tels = []
    for lane_i, (n, window_l, d) in enumerate(zip(counts, windows, lane_d)):
        f_ghz, f_idx = freq_columns[d]
        C_l = len(f_ghz)
        if n == 0:
            tels.append(_empty(window_l, C_l))
            continue
        tels.append(Telemetry(
            window_l,
            np.broadcast_to(np.asarray(f_idx, np.int32), (n, C_l)).copy(),
            np.broadcast_to(np.asarray(f_ghz, np.float32), (n, C_l)).copy(),
            util[:n, lane_i, :C_l], power[:n, lane_i], temps[:n, lane_i]))
    return tels


# --------------------------------------------------------------------------
# Reference-kernel static replay (numpy)
# --------------------------------------------------------------------------

def ref_static_telemetry(db: ResourceDB, result, governor,
                         window_us: Optional[float] = None) -> Telemetry:
    """Post-hoc telemetry replay of a static-governor reference run: window
    utilisation/power from the realised schedule (``result.records``), RC
    temperatures integrated in real time (dt = window), frequency columns
    from the governor.  Matches :func:`torch_static_telemetry` on comm-free
    traces (asserted in tests/test_torch_obs.py)."""
    window = (float(window_us) if window_us is not None
              else static_window(governor))
    C = domain_count(db)
    W = num_windows_for(result.makespan_us, window)
    if W == 0:
        return _empty(window, C)

    node_of_pe = _thermal.cluster_nodes(db)
    cl_cpus = np.zeros(C)
    for pe in db.pes:
        if pe.is_cpu:
            cl_cpus[pe.cluster] += 1.0
    p_idle = np.asarray([idle_power(pe) for pe in db.pes])

    util = np.zeros((W, C), np.float32)
    power_w = np.zeros((W, _thermal.NUM_NODES), np.float32)
    temps_c = np.full((W, 4), _thermal.T_AMBIENT_C, np.float32)
    rc_ab = _thermal.exact_step_matrices(window * 1e-6)
    temps = np.full(4, _thermal.T_AMBIENT_C)
    for w in range(W):
        w0, w1 = w * window, (w + 1) * window
        busy = np.zeros(db.num_pes)
        p = np.zeros(_thermal.NUM_NODES)
        for r in result.records:
            ov = max(0.0, min(r.finish_us, w1) - max(r.start_us, w0))
            if ov <= 0.0:
                continue
            pe = db.pes[r.pe_id]
            busy[r.pe_id] += ov
            p[node_of_pe[r.pe_id]] += active_power(pe, r.freq_ghz) * ov / window
            if pe.is_cpu:
                util[w, pe.cluster] += ov
        util[w] /= np.maximum(window * cl_cpus, 1e-9)
        idle_frac = 1.0 - np.clip(busy / window, 0.0, 1.0)
        for j in range(db.num_pes):
            p[node_of_pe[j]] += p_idle[j] * idle_frac[j]
        temps = _thermal.exact_step(temps, p, *rc_ab)
        power_w[w] = p
        temps_c[w] = temps

    f_ghz, f_idx = static_freq_columns(db, governor, C)
    return Telemetry(window,
                     np.broadcast_to(f_idx, (W, C)).copy(),
                     np.broadcast_to(f_ghz, (W, C)).copy(),
                     util, power_w, temps_c)
