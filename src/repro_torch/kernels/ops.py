"""Public wrappers of the kernels, in the reference's layouts.

The twin of ``src/repro/kernels/ops.py``; model code calls these when
``cfg.attn_impl == "cuda"``.  The reference transposes to (B,H,S,Dh) for its
kernels; the CUDA kernels read the (B,S,H,Dh) / (B,L,KV,Dh) layout through
strides, so nothing is transposed or copied here.

For a CUDA tensor a wrapper launches its kernel or raises; only a CPU tensor
goes to the kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

from . import decode_attention as _dec
from . import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: float = 1.0):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,KV,Dh) -> (B,Sq,H,Dh)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


def decode_attention(q, k, v, valid, *, softcap: Optional[float] = None,
                     scale: float = 1.0):
    """q: (B,1,H,Dh); k,v: (B,L,KV,Dh); valid: (L,) or (B,L) -> (B,1,H,Dh).
    A (L,) mask is broadcast over the batch by the wrapper."""
    return _dec.decode_attention(q, k, v, valid, softcap=softcap, scale=scale)
