"""The least time of an epoch-scan (K1) launch, from the cell's shapes.

K1 is a chain of dependent steps a lane (about 6,800 at 1,000 jobs of the
five apps), which no rate bounds, so its bound counts bytes only: the
tables of the D stacked designs and the (L, J) lanes read once, the
(L, J, T) schedule written once (bool, f32 start, f32 finish, i32 PE);
under DTPM also the OPP-indexed tables, each lane's policy (window,
threshold, cap, the 4x4 RC matrices, two exponents) and the latched OPPs,
final OPPs and peaks written once; with fail-stop faults also the (L, P)
fault plans read once, the (L, J, T) ready-time floor and the (L, 2) step
and commit counts written once.  The count is a frozen copy of the
program's own ``scan_bound_ms`` arithmetic, taken over shapes alone.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, at the full 700 W limit
PEAK_BYTES_S = 3.35e12

MAX_OPP_LEVELS = 5      # K: the longest OPP ladder of a CPU cluster
DOMAINS = 3             # C: big, LITTLE, the accelerator fabric


@dataclasses.dataclass(frozen=True)
class Launch:
    dtpm: bool
    D: int      # designs stacked
    L: int      # lanes
    J: int      # jobs a lane
    A: int      # applications
    T: int      # tasks of the largest application
    P: int      # PEs of the widest design (the padded width)
    C: int = DOMAINS
    K: int = MAX_OPP_LEVELS
    faults: bool = False    # the fail-stop program

    @property
    def bytes(self) -> int:
        A, T, P, D, L, J, C, K = (self.A, self.T, self.P, self.D, self.L,
                                  self.J, self.C, self.K)
        tables = 4 * D * (A * T * P + 2 * A * T + A * T * T + A + P * P + 2)
        n = tables + 8 * L * J + 13 * L * J * T
        if self.dtpm:
            n += 4 * (D * (A * T * P * (K - 1) + P * K + C * K + 3 * C + 4 * P)
                      + 37 * L + L * J * T + L * C + L)
        if self.faults:
            n += 4 * (L * P + L * J * T + 2 * L)
        return n

    @property
    def bound_s(self) -> float:
        return self.bytes / PEAK_BYTES_S
