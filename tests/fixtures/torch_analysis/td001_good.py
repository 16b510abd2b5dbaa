"""TD001 fixtures — tensor-carrying dataclasses done right (clean)."""
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Tables:                                  # identity equality and hash
    exec_us: torch.Tensor
    exec_opp: Optional[torch.Tensor]
    num_pes: int


@dataclasses.dataclass(frozen=True)
class Lanes:                                   # tensors kept out of __eq__
    window: torch.Tensor = dataclasses.field(compare=False)
    label: str = "lanes"


@dataclasses.dataclass
class Plain:                                   # no tensor: not audited
    rate: float
