"""Mamba2 block — SSD (state-space duality) with chunked computation.

The twin of ``src/repro/models/ssm.py``.  Prefill uses the chunked SSD
formulation: with ``cfg.attn_impl == "cuda"`` the hand-written ``ssd_scan``
kernel (K4; its plain version on a CPU tensor), otherwise the reference's
einsum form (intra-chunk quadratic block, chunk states, a serial pass over
chunks, inter-chunk term) in the model dtype as the reference casts it.
Decode is the O(1)-per-token recurrent step on (conv, ssm) state, with no
kernel (the reference has none there either); it updates the cache IN PLACE
(``decode_stack`` hands each layer a view of its stacked cache).

As in the reference, a prompt's length L must be a multiple of the chunk
``min(256, L)``; the port raises ``ValueError`` where the reference asserts.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import is_split, layout, reshape, shard
from .layers import causal_conv, conv_taps, dtype_of, shift_in
from .params import ParamStore

SSD_CHUNK = 256


def init_mamba(ps: ParamStore, path: str, cfg: ModelConfig,
               stacked: Optional[int]):
    D = cfg.d_model
    Din = cfg.d_inner                      # expand * d_model
    H = cfg.ssm_heads                      # Din // head_dim
    N = cfg.ssm_state
    conv_ch = Din + 2 * N                  # x, B, C are convolved
    pre = (stacked,) if stacked else ()
    pax = (None,) if stacked else ()
    ps.param(f"{path}/in_z", pre + (D, Din), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/in_xbc", pre + (D, conv_ch), pax + ("fsdp", "model"),
             "fan_in")
    ps.param(f"{path}/in_dt", pre + (D, H), pax + ("fsdp", None), "fan_in")
    ps.param(f"{path}/conv_w", pre + (cfg.conv_width, conv_ch),
             pax + (None, "model"), "normal", scale=0.1)
    ps.param(f"{path}/conv_b", pre + (conv_ch,), pax + ("model",), "zeros")
    ps.param(f"{path}/A_log", pre + (H,), pax + (None,), "zeros",
             dtype=torch.float32)
    ps.param(f"{path}/D", pre + (H,), pax + (None,), "ones", dtype=torch.float32)
    ps.param(f"{path}/dt_bias", pre + (H,), pax + (None,), "zeros",
             dtype=torch.float32)
    ps.param(f"{path}/norm", pre + (Din,), pax + ("model",), "ones",
             dtype=torch.float32)
    ps.param(f"{path}/out_proj", pre + (Din, D), pax + ("model", "fsdp"), "fan_in")


def _in_proj(p, x: torch.Tensor):
    dt_ = x.dtype
    z = x @ p["in_z"].to(dt_)
    xBC = x @ p["in_xbc"].to(dt_)
    dtr = x @ p["in_dt"].to(dt_)
    return z, xBC, dtr


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * w).to(y.dtype)


def inclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``, except under ``torch.use_deterministic_algorithms``
    (the mode ``launch/train.py`` trains in): torch has no deterministic float cumsum on
    a CUDA tensor and raises there, so the sum is then taken on any device in
    log2(n) vector steps of one fixed order (Hillis-Steele: after the step of
    distance d, element t holds the sum of (t-2d, t])."""
    if not torch.are_deterministic_algorithms_enabled():
        return torch.cumsum(x, dim)
    d, n = 1, x.shape[dim]
    while d < n:
        x = torch.cat([x.narrow(dim, 0, d),
                       x.narrow(dim, d, n - d) + x.narrow(dim, 0, n - d)], dim)
        d *= 2
    return x


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None, use_kernel: bool = False):
    """Chunked SSD.  x:(B,L,H,P) dt:(B,L,H) A:(H,) Bm,Cm:(B,L,N).

    Returns (y, h_last) with y:(B,L,H,P), h_last:(B,H,P,N).
    h_t = h_{t-1}·exp(A·dt_t) + dt_t·x_t⊗B_t ;  y_t = h_t·C_t
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    dtt = x.dtype

    xc = x.reshape(B, nc, chunk, H, P)                     # views: the kernel
    dtc = dt.reshape(B, nc, chunk, H).float()              # reads strides
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = Cm.reshape(B, nc, chunk, N)

    dA = dtc * A                                           # (B,nc,c,H) f32, <=0
    cs = inclusive_cumsum(dA, dim=2)

    if use_kernel:
        from ..kernels import ops as kops
        return kops.ssd_scan(xc, dtc, dA, cs, Bc, Cc, h0=h0)

    # ---- intra-chunk (diagonal block) -------------------------------------
    # decay(i, j) = exp(cs_i - cs_j) for i >= j  (per head).  The mask is
    # applied before exp: for i < j, cs_i - cs_j > 0 overflows exp at a chunk
    # of 256, and where(mask, exp(di), 0)'s backward would then multiply that
    # inf by 0 (the reference's form, whose gradient is NaN there); the
    # forward's values are the same bits.
    di = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B,nc,c,c,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask[None, None, :, :, None], di,
                                  -torch.inf))
    att = torch.einsum("bzin,bzjn->bzij", Cc.float(), Bc.float())
    w = att[..., None] * decay * dtc[:, :, None, :, :]     # (B,nc,c,c,H)
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", w.to(dtt), xc)

    # ---- chunk summary states ---------------------------------------------
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dtc           # (B,nc,c,H)
    states = torch.einsum("bzch,bzchp,bzcn->bzhpn", seg.to(dtt), xc, Bc)

    # ---- inter-chunk recurrence (serial over nc) --------------------------
    chunk_decay = torch.exp(cs[:, :, -1, :]).to(dtt)       # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=dtt, device=x.device) if h0 is None \
        else h0.to(dtt)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h)                                  # state entering z
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # ---- inter-chunk contribution  y_off = C_i · exp(cs_i) · h_prev -------
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", Cc,
                         torch.exp(cs).to(dtt), h_prev)
    y = (y_diag + y_off).reshape(B, L, H, P)
    return y, h


def _ssd_on_mesh(x, dt, A, Bm, Cm, chunk: int):
    """:func:`ssd_chunked` on a device mesh: each device scans its own batch
    rows and heads (split as the rules split "batch" and "model"; heads the
    axis does not divide stay whole, as XLA pads them) with B and C whole
    over the heads' axis (``local_map``).  Their gradients, and A's, come
    back as partial sums over the axes that split what they do not have."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    lx = layout(x.shape, "batch", None, "model", None)
    ldt = layout(dt.shape, "batch", None, "model")
    lA = layout(A.shape, "model")
    lbc = layout(Bm.shape, "batch", None, None)
    lh = layout((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]),
                "batch", "model", None, None)
    gA = tuple(Partial() if pl == Shard(0) else a for pl, a in zip(lx, lA))
    gbc = tuple(Partial() if pl == Shard(2) else b for pl, b in zip(lx, lbc))
    body = functools.partial(ssd_chunked, chunk=chunk)
    return local_map(body, out_placements=(lx, lh),
                     in_placements=(lx, ldt, lA, lbc, lbc),
                     in_grad_placements=(lx, ldt, gA, gbc, gbc),
                     redistribute_inputs=True)(x, dt, A, Bm, Cm)


def apply_mamba(p, cfg: ModelConfig, x: torch.Tensor, chunk: int = SSD_CHUNK,
                return_cache: bool = False):
    """Train/prefill forward.  x: (B,S,D) -> (B,S,D) [+ decode cache]."""
    B, S, D = x.shape
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype

    z, xBC, dtr = _in_proj(p, x)
    xBC = shard(xBC, "batch", None, "model")
    xBC_conv = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = (xBC_conv[..., :Din], xBC_conv[..., Din:Din + N],
                  xBC_conv[..., Din + N:])
    dt = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                              # (H,) negative

    xh = reshape(xs, (B, S, H, P))
    if is_split(xh, 0, 1, 2, 3):
        y, h_last = _ssd_on_mesh(xh, dt, A, Bm, Cm, min(chunk, S))
    else:
        y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, min(chunk, S),
                                use_kernel=(cfg.attn_impl == "cuda"))
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = reshape(y, (B, S, Din))
    y = _gated_rmsnorm(y, z, p["norm"], cfg.norm_eps)
    out = shard(y @ p["out_proj"].to(dt_), "batch", None, None)
    if not return_cache:
        return out
    cache = {"conv": conv_taps(xBC, cfg.conv_width),    # pre-activation taps
             "ssm": h_last.float()}
    return out, cache


# ---------------------------------------------------------------- decode

def init_mamba_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    dev = resolve_device(device)
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, Din + 2 * N),
                                dtype=dtype_of(cfg), device=dev),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=dev)}


def decode_mamba(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict):
    """One-token step.  x: (B,1,D) -> (B,1,D); ``cache`` is updated in place
    and returned."""
    B = x.shape[0]
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype

    z, xBC, dtr = _in_proj(p, x)
    hist = shift_in(cache["conv"], xBC[:, 0])               # (B,K,conv_ch)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(dt_)) \
        + p["conv_b"].to(dt_)
    xBC_t = F.silu(conv_out)
    xs, Bm, Cm = (xBC_t[..., :Din], xBC_t[..., Din:Din + N],
                  xBC_t[..., Din + N:])

    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])       # (B,H)
    A = -torch.exp(p["A_log"])                              # (H,)
    xh = reshape(xs, (B, H, P)).float()
    decay = torch.exp(dt * A)                               # (B,H)
    upd = (dt[..., None, None] * xh[..., None]
           * Bm.float()[:, None, None, :])                  # (B,H,P,N)
    h = cache["ssm"] * decay[..., None, None] + upd
    cache["ssm"].copy_(h)
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, Din).to(dt_)
    y = _gated_rmsnorm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, cache
