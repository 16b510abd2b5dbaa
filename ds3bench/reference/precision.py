"""The number formats the reference computes its times in.

``float32`` is the precision the configurations state: every time the
simulator stores (latencies, ready, start and finish times, queue drain
times) is rounded to float32, as the program stores them.  ``bfloat16`` is
the next precision below, the one the control computes in: each stored time
is rounded to the nearest bfloat16 (ties to even), kept in a float32.
"""
from __future__ import annotations

import numpy as np


def _bf16(x) -> np.float32:
    bits = np.asarray(x, np.float32).reshape(()).view(np.uint32)
    up = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return np.float32((np.uint32(bits + up) & np.uint32(0xFFFF0000))
                      .astype(np.uint32).view(np.float32))


def _bf16_array(x) -> np.ndarray:
    bits = np.asarray(x, np.float32).view(np.uint32)
    up = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + up) & np.uint32(0xFFFF0000)).astype(np.uint32) \
        .view(np.float32)


FORMATS = {
    "float32": (np.float32, lambda x: np.asarray(x, np.float32)),
    "bfloat16": (_bf16, _bf16_array),
}


def rounding(name: str):
    """``(scalar, array)`` rounding functions of a format."""
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; have {sorted(FORMATS)}")
