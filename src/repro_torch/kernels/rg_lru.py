"""RG-LRU linear recurrence: hand-written CUDA kernel + its plain PyTorch version.

Replaces the TPU kernel ``_rg_lru_kernel`` / ``rg_lru_bsw`` of
``src/repro/kernels/rg_lru.py``: ``h_t = a_t * h_{t-1} + x_t`` over (B,S,W)
f32, the whole trajectory out.  The kernel is ``csrc/rg_lru.cu`` (design notes
at its top).  On an H100 the function is bound by bytes (a, x read and h
written once); the recurrence is sequential in S, so the kernel splits S into
segments inside a block, scans them, chains their end states and scans again
from the right carry.  Unlike the Pallas grid (``rg_lru.py:48``) it takes any S
and any W.

``rg_lru`` launches the kernel for a CUDA tensor or raises; only a CPU tensor
goes to ``rg_lru_plain``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
_fn = None


def rg_lru_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (B,S,W) f32 -> h: (B,S,W) f32.  A sequential loop over S (the twin
    of the reference's ``rg_lru_ref``)."""
    a, x = a.float(), x.float()
    h = torch.zeros_like(x[:, 0])
    out = torch.empty_like(x)
    for t in range(x.shape[1]):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("rg_lru")
        fn = lib.repro_rg_lru
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        err = lib.repro_rg_lru_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def rg_lru(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (B,S,W) f32 -> h: (B,S,W) f32, any S >= 1 and W >= 1.

    Read through their strides; the last dim must be contiguous."""
    if a.device.type == "cpu":
        return rg_lru_plain(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: no kernel for device {a.device}")
    if a.ndim != 3 or x.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"rg_lru: shapes a {tuple(a.shape)}, x {tuple(x.shape)}")
    for name, t in (("a", a), ("x", x)):
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"rg_lru: {name} is {t.dtype} on {t.device}; the "
                             f"kernel takes float32 on {a.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"rg_lru: {name} needs a contiguous last dim; "
                             f"got strides {t.stride()}")
    B, S, W = a.shape
    fn, err = _kernel()
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    global launches
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), x.data_ptr(), h.data_ptr(), B, S, W,
                a.stride(0), a.stride(1), x.stride(0), x.stride(1),
                h.stride(0), h.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru launch failed: {err(rc).decode()}")
    launches += 1
    return h
