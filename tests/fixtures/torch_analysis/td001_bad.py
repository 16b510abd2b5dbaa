"""TD001 fixtures — tensor-carrying dataclasses (all bad)."""
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(eq=False)
class Mutable:                                 # TD001 not frozen
    x: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Compared:                                # TD001 generated __eq__
    x: torch.Tensor
    n: int


@dataclasses.dataclass(frozen=True)
class Half:                                    # TD001 y still compared
    x: torch.Tensor = dataclasses.field(compare=False)
    y: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Both:                                    # TD001 twice
    x: torch.Tensor
