"""Flash-decode: hand-written CUDA kernel + its plain PyTorch version.

Replaces the TPU kernel ``_decode_kernel`` / ``decode_attention_bhd`` of
``src/repro/kernels/decode_attention.py``.  The kernel is
``csrc/decode_attention.cu`` (design notes at its top).  On an H100 the
function is bound by bytes: each valid K and V row of the cache is read once.
So one block serves all (up to 16) query heads of its KV head from one pass
over K/V, the cache length is split across blocks, and the last block of each
(batch, KV head) merges the partial softmax states in the same launch (found by
an atomic counter); a warp fetches the K and V rows of 16 keys at once with
16-byte asynchronous copies, and slots whose ``valid`` is false are not loaded.
bfloat16 runs both products on the tensor cores (``mma.sync``, the group's
queries as the rows of a 16-row tile), float32 on the CUDA cores.

``decode_attention`` launches the kernel for a CUDA tensor or raises; only a
CPU tensor goes to ``decode_attention_plain``.  ``launches`` counts calls, one
launch each.  The merge counters are one zeroed buffer per (device, stream),
allocated at the first call on that stream and left at zero by every launch:
calls on one stream run in order, so no two launches share a counter, and
calls on two streams use two buffers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 256            # keys per split (a multiple of 64: one pass of a block)
MIN_CHUNK = 64
MAX_SPLITS = 512
TARGET_BLOCKS = 64     # the least grid before splits get shorter (see split_plan)
MAX_GROUP = 16         # query heads per KV head one block serves

launches = 0
_fn = None
_counters = {}         # (device, stream) -> int32 merge counters, zero between calls


def decode_attention_plain(q, k, v, valid, *, softcap: Optional[float] = None,
                           scale: float = 1.0):
    """q: (B,1,H,Dh); k,v: (B,L,KV,Dh); valid: (L,) or (B,L) -> (B,1,H,Dh).

    f32 throughout; follows the kernel: masked probabilities forced to 0, so a
    slot with no valid key gives 0.
    """
    B, _, H, Dh = q.shape
    L, KV = k.shape[1], k.shape[2]
    g = H // KV
    if valid.ndim == 1:
        valid = valid[None, :].expand(B, L)
    ok = valid.bool()[:, None, None, None, :]
    qg = q.reshape(B, 1, KV, g, Dh).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def split_plan(L: int, groups: int = 1):
    """(keys per split, number of splits) for a cache of length L read by
    ``groups`` (batch, KV head) pairs, one block per pair and split: CHUNK keys
    per split, halved down to MIN_CHUNK while the grid has fewer than
    TARGET_BLOCKS blocks, and more than CHUNK where L would need more than
    MAX_SPLITS splits.  Longer splits mean fewer partials for the last block
    to merge; on an H100 256 keys beat 128 and 64 at gemma2-2b's caches (16
    groups) and 128 beat 256 and 64 at recurrentgemma-2b's ring (4 groups)
    (``tools/tune_decode_split.py``, PERF.md)."""
    chunk = CHUNK
    while chunk > MIN_CHUNK and groups * -(-L // chunk) < TARGET_BLOCKS:
        chunk //= 2
    chunk = max(chunk, -(-L // MAX_SPLITS))
    chunk = -(-chunk // MIN_CHUNK) * MIN_CHUNK
    return chunk, -(-L // chunk)


def _counter_buffer(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``stream`` of
    ``device``, made once (a later, larger need makes a larger buffer once
    more); the kernel leaves them at 0."""
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _counters[(device, stream)] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.repro_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        err = lib.repro_decode_attention_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def _check(name: str, t: torch.Tensor, q: torch.Tensor, vec: int):
    """``vec`` contiguous elements are fetched by one aligned load or copy."""
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"decode_attention: {name} is {t.dtype} on {t.device},"
                         f" q is {q.dtype} on {q.device}")
    align = vec * t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
            or t.data_ptr() % align:
        raise ValueError(f"decode_attention: {name} needs a contiguous last "
                         f"dim, strides that are multiples of {vec} and a "
                         f"{align}-byte aligned base; got strides {t.stride()}")


def decode_attention(q, k, v, valid, *, softcap: Optional[float] = None,
                     scale: float = 1.0):
    """q: (B,1,H,Dh); k,v: (B,L,KV,Dh); valid: (L,) or (B,L) bool -> (B,1,H,Dh).

    K and V are read through their strides (a slice of a stacked cache is taken
    as it is).  At most 16 query heads per KV head, on every device, so that
    what runs on the CPU runs on the card.
    """
    if q.ndim == 4 and k.ndim == 4 and k.shape[2] > 0 \
            and q.shape[2] // k.shape[2] > MAX_GROUP:
        raise ValueError(f"decode_attention: {q.shape[2] // k.shape[2]} query "
                         f"heads per KV head; the kernel serves at most "
                         f"{MAX_GROUP} from one block")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, softcap=softcap,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _build.refuse_grad("decode_attention", q, k, v)
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, H, Dh = q.shape
    L, KV = k.shape[1], k.shape[2]
    if k.shape != (B, L, KV, Dh) or L < 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"decode_attention: H={H} is not a multiple of KV={KV}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {Dh} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} (float32, bfloat16)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"decode_attention: softcap {softcap} <= 0")
    if valid.ndim == 1:
        valid = valid[None, :].expand(B, L)
    if valid.shape != (B, L) or valid.device != q.device:
        raise ValueError(f"decode_attention: valid {tuple(valid.shape)} on "
                         f"{valid.device}, want {(B, L)} on {q.device}")
    if valid.dtype != torch.bool:
        valid = valid != 0
    vec = 16 // q.element_size()       # rows are read in 16-byte pieces
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q, vec)

    fn, err = _kernel()
    chunk, ns = split_plan(L, B * KV)
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    # scratch of the partial states: acc (B,H,ns,Dh), then m and l (B,H,ns)
    # each.  It (like `vbytes`) is dropped when this function returns, before
    # the kernel has run: that is safe because the caching allocator hands the
    # memory only to later work on the same stream.
    rows = B * H * ns
    part = torch.empty(rows * (Dh + 2), dtype=torch.float32, device=q.device)
    part_acc = part.data_ptr()
    part_m = part_acc + 4 * rows * Dh
    part_l = part_m + 4 * rows
    vbytes = valid.view(torch.uint8)
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counter_buffer(q.device, stream, B * KV)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vbytes.data_ptr(),
                out.data_ptr(), part_acc, part_m, part_l,
                counters.data_ptr(), _DTYPES[q.dtype],
                B, H, KV, L, Dh, chunk, ns,
                q.stride(0), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                vbytes.stride(0), vbytes.stride(1),
                out.stride(0), out.stride(2),
                float(softcap or 0.0), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: {err(rc).decode()}")
    launches += 1
    return out
