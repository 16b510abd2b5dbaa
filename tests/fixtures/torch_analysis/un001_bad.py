"""UN001 fixtures — unit-less numeric fields on a result struct (bad)."""
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EvalResult:
    latency: np.ndarray                        # UN001 no unit suffix
    energy_j: np.ndarray
    temperature: float                         # UN001 no unit suffix
    power: torch.Tensor                        # UN001 a tensor is numeric
    num_designs: int                           # int: exempt

    def to_dict(self):
        return {"latency": 0.0,                # UN001 payload key
                "energy_j": 0.0}
