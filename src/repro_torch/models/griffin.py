"""Griffin recurrent block (RecurrentGemma): conv1d + RG-LRU gated recurrence.

    y = W_out( GeLU(W_gate·x) ⊙ RG-LRU(conv1d(W_x·x)) )

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = σ(blockdiag(W_a)·u_t + b_a)          recurrence gate
    i_t = σ(blockdiag(W_i)·u_t + b_i)          input gate
    log a_t = -c · softplus(Λ) · r_t           (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t)

The twin of ``src/repro/models/griffin.py``.  Prefill evaluates the recurrence
with the hand-written ``rg_lru`` kernel (K5) when ``cfg.attn_impl == "cuda"``
(its plain version on a CPU tensor), or with a log-depth doubling scan, the
twin of the reference's ``associative_scan``.  Decode is the O(1) recurrent
step and updates the cache IN PLACE (``decode_stack`` hands each layer a view
of its stacked cache and keeps no returned copy).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import reshape, shard
from .layers import causal_conv, conv_taps, dtype_of, shift_in
from .params import ParamStore

RG_LRU_C = 8.0


def init_griffin(ps: ParamStore, path: str, cfg: ModelConfig,
                 stacked: Optional[int]):
    D, W = cfg.d_model, cfg.lru_width
    H = cfg.num_heads                         # gate blocks
    bw = W // H
    pre = (stacked,) if stacked else ()
    pax = (None,) if stacked else ()
    ps.param(f"{path}/w_x", pre + (D, W), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/w_gate", pre + (D, W), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/conv_w", pre + (cfg.conv_width, W), pax + (None, "model"),
             "normal", scale=0.1)
    ps.param(f"{path}/conv_b", pre + (W,), pax + ("model",), "zeros")
    ps.param(f"{path}/wa", pre + (H, bw, bw), pax + (None, None, None), "fan_in")
    ps.param(f"{path}/ba", pre + (W,), pax + ("model",), "zeros",
             dtype=torch.float32)
    ps.param(f"{path}/wi", pre + (H, bw, bw), pax + (None, None, None), "fan_in")
    ps.param(f"{path}/bi", pre + (W,), pax + ("model",), "zeros",
             dtype=torch.float32)
    # Λ init so that a = exp(-c·softplus(Λ)) lands in (0.9, 0.999)
    ps.param(f"{path}/lam", pre + (W,), pax + ("model",), "normal", scale=0.5,
             dtype=torch.float32)
    ps.param(f"{path}/w_out", pre + (W, D), pax + ("model", "fsdp"), "fan_in")


def _block_linear(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: u (...,W), w (H,bw,bw) -> (...,W)."""
    H, bw, _ = w.shape
    uh = reshape(u, (*u.shape[:-1], H, bw))
    y = torch.einsum("...hi,hij->...hj", uh, w.to(u.dtype))
    return reshape(y, u.shape) + b.to(u.dtype)


def _gates(p, u: torch.Tensor):
    """Returns (log_a, gated_input) in f32; u: (..., W)."""
    uf = u.float()
    r = torch.sigmoid(_block_linear(uf, p["wa"].float(), p["ba"]))
    i = torch.sigmoid(_block_linear(uf, p["wi"].float(), p["bi"]))
    log_a = -RG_LRU_C * F.softplus(p["lam"]) * r              # (..., W) <= 0
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * i * uf


def _doubling_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + x_t along dim 1 in log2(S) vector steps (Hillis-
    Steele): after the step of distance d, (A, X) at t compose the elements
    (t-2d, t]."""
    A, X = a, x
    d, S = 1, a.shape[1]
    while d < S:
        X = torch.cat([X[:, :d], A[:, d:] * X[:, :-d] + X[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], dim=1)
        d *= 2
    return X


def rg_lru_scan(p, u: torch.Tensor, h0: Optional[torch.Tensor],
                use_kernel: bool = False):
    """u: (B,S,W) -> (h_all: (B,S,W) f32, h_last: (B,W) f32)."""
    log_a, x_in = _gates(p, u)                              # f32
    a = torch.exp(log_a)
    if use_kernel:
        from ..kernels import ops as kops
        h = kops.rg_lru(a, x_in, h0)
    else:
        if h0 is not None:
            x_in = x_in.clone()
            x_in[:, 0] += a[:, 0] * h0
        h = _doubling_scan(a, x_in)
    return h, h[:, -1, :]


def apply_griffin(p, cfg: ModelConfig, x: torch.Tensor,
                  return_cache: bool = False):
    """Train/prefill.  x: (B,S,D) -> (B,S,D) [+ decode cache]."""
    dt_ = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt_), approximate="tanh")
    u = shard(x @ p["w_x"].to(dt_), "batch", None, "model")
    u_conv = causal_conv(u, p["conv_w"], p["conv_b"])
    h, h_last = rg_lru_scan(p, u_conv, None,
                            use_kernel=(cfg.attn_impl == "cuda"))
    y = gate * h.to(dt_)
    out = shard(y @ p["w_out"].to(dt_), "batch", None, None)
    if not return_cache:
        return out
    return out, {"conv": conv_taps(u, cfg.conv_width), "h": h_last.clone()}


def init_griffin_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    dev = resolve_device(device)
    W = cfg.lru_width
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=dtype_of(cfg), device=dev),
            "h": torch.zeros((batch, W), dtype=torch.float32, device=dev)}


def decode_griffin(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict):
    """One-token step.  x: (B,1,D) -> (B,1,D); ``cache`` is updated in place
    and returned."""
    dt_ = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt_), approximate="tanh")
    u = (x @ p["w_x"].to(dt_))[:, 0]                        # (B,W)
    hist = shift_in(cache["conv"], u)                       # (B,K,W)
    u_conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(dt_)) \
        + p["conv_b"].to(dt_)
    log_a, x_in = _gates(p, u_conv)
    h = torch.exp(log_a) * cache["h"] + x_in                # (B,W) f32
    cache["h"].copy_(h)
    y = gate[:, 0] * h.to(dt_)
    out = (y @ p["w_out"].to(dt_))[:, None, :]
    return out, cache
