"""RG-LRU linear recurrence: hand-written CUDA kernel + its plain PyTorch version.

Replaces the TPU kernel ``_rg_lru_kernel`` / ``rg_lru_bsw`` of
``src/repro/kernels/rg_lru.py``: ``h_t = a_t * h_{t-1} + x_t`` over (B,S,W)
f32, the whole trajectory out.  The kernel is ``csrc/rg_lru.cu`` (design notes
at its top).  On an H100 the function is bound by bytes (a, x read and h
written once), and the kernel reads a and x from device memory once: a block
owns 32 channels by ``CHUNK`` rows of S, holds its rows in registers, scans
them from 0, and takes the state entering its chunk from the slots that
earlier chunks published (every ``ANCHOR``-th chunk its inclusive state, the
others their aggregates), folded in one fixed order; then it rescans from it.
S is split across blocks, so B=1 fills every SM, and every call returns the
same bits.  Unlike the Pallas grid (``rg_lru.py:48``) it takes any S and W.

``rg_lru`` launches the kernel for a CUDA tensor or raises; only a CPU tensor
goes to ``rg_lru_plain``.  ``launches`` counts calls, one launch each.  The
blocks hand each other their states through one int64 scratch buffer per
(device, stream), zeroed once when it is made (``scratch_words`` says how
large a call needs it; a larger need makes a larger buffer once more) and
never between calls: the kernel empties what it used itself, so a call is one
launch and nothing else, inside a CUDA graph too.  Calls on one stream run in
order, so no two launches share a buffer.  Under CUDA-graph capture, make one
call of the largest shape on the capturing stream first, or the buffer's
zero-fill lands in the graph.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

CH = 32          # channels per tile, one per lane (csrc/rg_lru.cu)
WARPS = 8        # warps per block
ROWS = 16        # rows of S per warp
CHUNK = WARPS * ROWS    # rows of S per block
ANCHOR = 4       # every ANCHOR-th chunk publishes its inclusive state
HEADER = 4       # int64 words of scratch before the slots (call and ticket, ...)
SLOT = CH        # int64 words per slot: a (P, E) pair per lane, two banks
COUNT_BITS = 24  # the header's low bits count a call's tickets
MIN_WORDS = 1 << 18     # the smallest scratch buffer made (2 MiB)

launches = 0
_fn = None
_scratch = {}    # (device, stream) -> int64 scratch, zeroed once


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


def geometry(B: int, S: int, W: int):
    """(tiles, chunks, blocks) of one call: 32-channel tiles by CHUNK-row
    chunks of S, per batch row, one block each."""
    tiles, chunks = -(-W // CH), -(-S // CHUNK)
    return tiles, chunks, B * tiles * chunks


def scratch_words(B: int, S: int, W: int) -> int:
    """int64 words of scratch one call needs: the header and one slot per
    block on each of two banks."""
    return HEADER + 2 * SLOT * geometry(B, S, W)[2]


def _scratch_buffer(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int64 words of scratch for launches on ``stream`` of
    ``device``, zeroed when made (a later, larger need makes a larger buffer
    once more, zeroed again); the kernel keeps it consistent between calls."""
    buf = _scratch.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _scratch[(device, stream)] = torch.zeros(
            max(n, MIN_WORDS), dtype=torch.int64, device=device)
    return buf


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("rg_lru")
        fn = lib.repro_rg_lru
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        err = lib.repro_rg_lru_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def kernel_info(device=None) -> dict:
    """The built kernel's geometry: rows of S per block, channels per tile,
    scratch header and slot words, threads per block, resident blocks per SM
    on ``device`` and chunks per anchor (the sizes checked against this
    module's constants)."""
    lib = _build.load("rg_lru")
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        rc = lib.repro_rg_lru_info(out)
    if rc != 0:
        raise RuntimeError(f"rg_lru info failed: {_kernel()[1](rc).decode()}")
    info = dict(zip(("chunk_rows", "channels", "header", "slot", "threads",
                     "blocks_per_sm", "anchor"), out))
    if (info["chunk_rows"], info["channels"], info["header"], info["slot"],
            info["anchor"]) != (CHUNK, CH, HEADER, SLOT, ANCHOR):
        raise RuntimeError(f"rg_lru: csrc/rg_lru.cu's geometry {info} differs "
                           f"from rg_lru.py's")
    return info


def rg_lru(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (B,S,W) f32 -> h: (B,S,W) f32, any S >= 1 and W >= 1.

    Read through their strides; the last dim must be contiguous."""
    if a.device.type == "cpu":
        return rg_lru_plain(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: no kernel for device {a.device}")
    _build.refuse_grad("rg_lru", a, x)
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
    if geometry(B, S, W)[2] >= 1 << COUNT_BITS:
        raise ValueError(f"rg_lru: shape {(B, S, W)} needs 2^{COUNT_BITS} "
                         "blocks or more")
    fn, err = _kernel()
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    global launches
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch_buffer(a.device, stream, scratch_words(B, S, W))
        rc = fn(a.data_ptr(), x.data_ptr(), h.data_ptr(), scratch.data_ptr(),
                B, S, W, a.stride(0), a.stride(1), x.stride(0), x.stride(1),
                h.stride(0), h.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru launch failed: {err(rc).decode()}")
    launches += 1
    return h
