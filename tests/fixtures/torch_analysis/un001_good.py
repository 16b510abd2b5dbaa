"""UN001 fixtures — suffixed/allowlisted fields (clean)."""
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    total_energy_j: float
    avg_power_w: float
    makespan_us: float
    peak_temp_c: float
    freq_ghz: float
    utilization: np.ndarray            # allowlisted (dimensionless)
    freq_idx: np.ndarray               # allowlisted (*_idx)
    num_pes: int                       # int: exempt
    telemetry: Optional[np.ndarray] = None   # allowlisted container

    def to_dict(self):
        return dict(total_energy_j=self.total_energy_j,
                    avg_power_w=self.avg_power_w,
                    makespan_us=self.makespan_us)


@dataclasses.dataclass
class NotAudited:
    latency: float                     # class not in unit-structs: ignored
