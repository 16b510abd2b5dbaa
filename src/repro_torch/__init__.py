"""PyTorch/CUDA port of the ``repro`` package (the JAX reference stays beside it).

Same sub-package and function names as the reference so a reader finds the
counterpart; PyTorch idiom inside.  This package imports ``torch`` and
``numpy`` only — never ``jax`` and nothing from ``repro``.

Every constructor and entry point takes an explicit ``device`` that defaults
to ``"cuda"`` and raises where there is no card; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels (the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if it names a GPU that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
