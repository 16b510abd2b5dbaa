"""Public wrappers of the kernels, in the reference's layouts.

The twin of ``src/repro/kernels/ops.py``; model code calls these when
``cfg.attn_impl == "cuda"``, and the simulator (``core/simkernel_torch.py``)
calls ``epoch_scan``.  The reference transposes to (B,H,S,Dh) and
(B,H,nc,c,P) for its kernels; the CUDA kernels read the model's (B,S,H,Dh),
(B,L,KV,Dh) and (B,nc,c,H,P) layouts through strides, so nothing is
transposed or copied here.

For a CUDA tensor a wrapper launches its kernel or raises; only a CPU tensor
goes to the kernel's plain PyTorch version.  A kernel has no backward, so on a
CUDA tensor a wrapper also raises while autograd records and an input
requires grad (``_build.refuse_grad``): train on ``attn_impl="blocked"``.
"""
from __future__ import annotations

from typing import Optional

from . import decode_attention as _dec
from . import epoch_scan as _scan
from . import flash_attention as _fa
from . import rg_lru as _lru
from . import ssd_scan as _ssd


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


def ssd_scan(xc, dtc, dA, cs, Bc, Cc, h0=None):
    """Adapter matching ``repro_torch.models.ssm.ssd_chunked``'s kernel call.

    xc: (B,nc,c,H,P); dtc/cs: (B,nc,c,H) f32; Bc,Cc: (B,nc,c,N); ``dA`` is
    not read (``cs`` carries it), as in the reference.
    Returns (y: (B, L, H, P), h_last: (B,H,P,N) f32)."""
    if h0 is not None:
        raise ValueError("ssd_scan: the kernel starts from a zero state; "
                         "prefill state chaining uses the einsum path")
    B, nc, c, H, P = xc.shape
    y, h_last = _ssd.ssd_scan(xc, dtc, cs, Bc, Cc)
    return y.reshape(B, nc * c, H, P), h_last


def rg_lru(a, x, h0=None):
    """a, x: (B,S,W) f32 -> hidden trajectory (B,S,W) f32; ``h0`` (B,W) is
    folded into ``x[:, 0]`` as the reference does."""
    if h0 is not None:
        x = x.clone()
        x[:, 0] += a[:, 0] * h0
    return _lru.rg_lru(a, x)


def epoch_scan(tables, policy: str, arrival, app_idx, gov=None, faults=None):
    """K1: the epoch scan of ``L`` lanes of one table set.
    arrival (L, J) f32, app_idx (L, J) int on the tables' device ->
    (scheduled, start, finish, onpe), each (L, J, T); with ``gov`` (a
    ``core.dvfs.PolicyLanes`` of L lanes) the DTPM program, which adds
    (onopp (L, J, T), opp_idx (L, C), peak_temp_c (L,)); with ``faults``
    ((L, P) f32 fail times) the fail-stop program, which adds counts
    (L, 2) int32 (steps taken, tasks committed)."""
    return _scan.epoch_scan(tables, policy, arrival, app_idx, gov=gov,
                            faults=faults)
