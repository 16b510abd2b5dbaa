"""Plain PyTorch oracles of the ported kernels, under the reference's names.

The twin of ``src/repro/kernels/ref.py``.  ``ssd_ref`` and ``rg_lru_ref``
are the sequential recurrences (the ground truth that the chunked and the
segmented scans are held to); the attention oracles are the kernels' plain
versions.  One difference, stated in the tests: on a row with no valid key
the JAX oracle returns the mean of ``v`` (a softmax over equal -1e30 scores);
these follow the kernels and return 0.
"""
import torch

from .decode_attention import decode_attention_plain as decode_attention_ref
from .flash_attention import flash_attention_plain as flash_attention_ref
from .rg_lru import rg_lru_plain as rg_lru_ref

__all__ = ["flash_attention_ref", "decode_attention_ref", "ssd_ref",
           "rg_lru_ref"]


def ssd_ref(x, dt, A, Bm, Cm):
    """Naive sequential SSM recurrence (the SSD ground truth).

    x: (B,L,H,P); dt: (B,L,H) f32; A: (H,); Bm,Cm: (B,L,N).
    h_t = h_{t-1}·exp(A·dt_t) + dt_t·x_t⊗B_t ;  y_t = h_t·C_t
    Returns (y: (B,L,H,P), h_last: (B,H,P,N)) in f32.
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf, dt = x.float(), Bm.float(), Cm.float(), dt.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A)                             # (B,H)
        upd = dt[:, t, :, None, None] * xf[:, t, :, :, None] \
            * Bf[:, t, None, None, :]
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h
