"""Flash attention: hand-written CUDA kernels + their plain PyTorch version.

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention_bhsd`` of
``src/repro/kernels/flash_attention.py``.  On an H100 the function is bound by
operations at long sequences (4·B·H·Dh·Σ_rows keys attended FLOP).
``csrc/flash_attention.cu`` (design notes at its top) holds two kernels, picked
by the input type:

* bfloat16 runs on the tensor cores: a block of 4 warps owns 64 query rows of a
  (batch, head), K/V tiles arrive by ``cp.async`` into a double-buffered ring of
  bf16 shared memory, and both products are ``mma.sync`` m16n8k16 with f32
  accumulators, the online softmax on the fragments in registers; keys per
  tile by ``key_tile``;
* float32 runs on the CUDA cores (32 query rows a block, 32-key tiles, f32 in
  shared memory): TF32 or bf16 products could not hold 2e-5.

Both loop over key tiles between the window's lower edge and the causal edge.
``flash_attention`` launches a kernel for a CUDA tensor or raises; only a CPU
tensor goes to ``flash_attention_plain``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM_64 = 1.3   # see key_tile

launches = 0
_fn = None
_sms = {}              # device -> number of SMs


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: float = 1.0):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,KV,Dh) -> (B,Sq,H,Dh).  Full softmax, f32.

    Follows the kernel's arithmetic: ``scale`` folded into q, masked scores at
    -1e30 with their probabilities forced to 0, so a fully masked row gives 0.
    """
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, Dh).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def key_tile(S: int, Dh: int, B: int, H: int, sms: int) -> int:
    """Keys per tile of the bf16 kernel: 64, except at head_dim 256 once the
    grid of B·H·ceil(S/64) blocks holds more than BLOCKS_PER_SM_64 blocks per SM
    of the ``sms`` SMs.  BK=64 takes one block an SM and crosses half the
    barriers; BK=32 lets two blocks share an SM and hide each other's softmax,
    which pays once most SMs have a second block to run.  On an H100 64 was
    9-12% faster at 0.97 and 1.21 blocks per SM, 32 3-31% faster from 1.45 to
    6 (``tools/tune_flash_tiles.py``, PERF.md)."""
    blocks = B * H * -(-S // 64)
    return 32 if Dh == 256 and blocks > BLOCKS_PER_SM_64 * sms else 64


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
        err = lib.repro_flash_attention_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def _check(name: str, t: torch.Tensor, q: torch.Tensor, vec: int):
    """``vec`` elements are fetched by one aligned load."""
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                         f"q is {q.dtype} on {q.device}")
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
            or t.data_ptr() % (vec * t.element_size()):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous last dim"
            + f", strides that are multiples of {vec} and a "
              f"{vec * t.element_size()}-byte aligned base; got strides "
              f"{t.stride()}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: float = 1.0):
    """q: (B,S,H,Dh); k,v: (B,S,KV,Dh) -> (B,S,H,Dh), any S >= 1.

    Tensors are read through their strides, so views such as a sliced
    projection are taken as they are: the last dim must be contiguous, and q,
    k and v need a 16-byte aligned base and strides that are multiples of 16
    bytes.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, Dh) or S < 1:
        raise ValueError("flash_attention: the kernel takes self-attention "
                         f"(Sq == Sk >= 1); q {tuple(q.shape)}, k {tuple(k.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of KV={KV}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} (float32, bfloat16)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    vec = 16 // q.element_size()       # rows are read in 16-byte chunks
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q, vec)
    sms = _sms.get(q.device)
    if sms is None:
        sms = _sms[q.device] = torch.cuda.get_device_properties(
            q.device).multi_processor_count
    return _launch(q, k, v, causal, window, softcap, scale,
                   key_tile(S, Dh, B, H, sms))


def _launch(q, k, v, causal, window, softcap, scale, bk: int):
    """One launch on checked inputs with ``bk`` keys per tile (bf16)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    fn, err = _kernel()
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, S, Dh, bk,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                int(causal), int(window or 0), float(softcap or 0.0),
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: {err(rc).decode()}")
    launches += 1
    return out
