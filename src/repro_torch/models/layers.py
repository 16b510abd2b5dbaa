"""Shared layers: norms, RoPE, MLPs, embeddings.

The twin of ``src/repro/models/layers.py``: ``init_*`` declares parameters into
a ParamStore, ``apply_*`` consumes the resulting nested dict.  Plain functions
on tensors; the matrix products here are outside every kernel and stay
``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import is_split, pinned, shard
from .params import ParamStore

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------- RMSNorm

def init_rmsnorm(ps: ParamStore, path: str, dim: int, stacked: Optional[int]):
    shape = (stacked, dim) if stacked else (dim,)
    axes = (None, "embed") if stacked else ("embed",)
    ps.param(f"{path}/scale", shape, axes, init="ones", dtype=torch.float32)


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 inside; multiplies by ``scale`` (an f32 leaf), not ``1 + scale``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles in f32, each (..., S, 1, half), for
    positions broadcastable to (..., S).  Depends on the positions only, so
    one pair serves q and k, and every layer of a decode tick."""
    freqs = rope_frequencies(head_dim, theta, positions.device)   # (half,)
    angles = positions[..., None].float() * freqs                 # (...,S,half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Half-split
    rotation (not interleaved), angles in f32.  ``tables``: the
    ``rope_tables`` of these positions, if the caller has them already."""
    half = x.shape[-1] // 2
    cos, sin = tables if tables is not None \
        else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- MLP

def init_mlp(ps: ParamStore, path: str, cfg: ModelConfig, d_ff: int,
             stacked: Optional[int]):
    D, F_ = cfg.d_model, d_ff
    pre = (stacked,) if stacked else ()
    pax = (None,) if stacked else ()
    if cfg.act in ("silu", "geglu"):          # only these are gated
        ps.param(f"{path}/w_gate", pre + (D, F_), pax + ("fsdp", "model"),
                 "fan_in")
    ps.param(f"{path}/w_in", pre + (D, F_), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/w_out", pre + (F_, D), pax + ("model", "fsdp"), "fan_in")


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")      # the reference's gelu default


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = _act(cfg, h)
    h = shard(h, "batch", None, "model")
    # the output's partial sum over the split mlp dimension reduced at once
    # (no-op without a device mesh), as the block's output constraint would
    return shard(h @ p["w_out"].to(x.dtype), "batch", None, None)


# ---------------------------------------------------------------- causal conv

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  x: (B,S,C); w: (K,C); b: (C,).  The
    reference's ``_causal_conv`` of ``ssm.py`` and ``griffin.py`` (the same
    function twice), summed in the same order."""
    K, S = w.shape[0], x.shape[1]
    # the zeros by a concatenation, not ``F.pad``: some DTensor versions
    # cannot pad a split tensor
    pad = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    y = sum(pad[:, k:k + S, :] * w[k].to(x.dtype) for k in range(K))
    return y + b.to(x.dtype)


def conv_taps(u: torch.Tensor, K: int) -> torch.Tensor:
    """The decode cache of a causal conv after a prefill of u (B,S,C): its last
    K-1 inputs (B,K-1,C), a new tensor.  A prompt shorter than K-1 is padded
    on the left with zeros, which is what the prefill's conv saw there.  (The
    reference slices ``u[:, S-(K-1):]`` and its engine broadcasts the shorter
    slice over the K-1 slots instead.)"""
    B, S, C = u.shape
    taps = u.new_zeros((B, K - 1, C))
    n = min(S, K - 1)
    if n:
        taps[:, K - 1 - n:] = u[:, S - n:]
    return taps


def shift_in(taps: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Decode step of a causal conv's cache, IN PLACE: taps (B,K-1,C) <- the
    last K-1 of [taps, new (B,C)]; returns the K inputs (B,K,C) the step's
    conv reads.  The window is shifted through that new tensor: an
    overlapping ``taps[:, :-1] = taps[:, 1:]`` is not safe."""
    hist = torch.cat([taps, new[:, None, :].to(taps.dtype)], dim=1)
    taps.copy_(hist[:, 1:])
    return hist


# ---------------------------------------------------------------- embeddings

def init_embeddings(ps: ParamStore, cfg: ModelConfig):
    # std 1/sqrt(D): with the sqrt(D) embedding multiplier the residual
    # stream starts at unit RMS and tied logits stay O(1)
    ps.param("embed/tok", (cfg.padded_vocab, cfg.d_model), ("model", "fsdp"),
             "normal", scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        ps.param("embed/head", (cfg.d_model, cfg.padded_vocab),
                 ("fsdp", "model"), "fan_in")


def embed_tokens(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    # on a device mesh the tokens are made whole first: the gather DTensor's
    # lookup in a split table does itself, made explicit because that
    # lookup masks real (not ``meta``) rows by the tokens before the gather
    tokens = shard(tokens, None, None)
    # ... and the lookup's partial sum over a split vocabulary reduced at
    # once (DTensor versions differ on when they would reduce it)
    x = shard(F.embedding(tokens, pinned(p["embed"]["tok"])),
              "batch", None, None).to(dt)
    # gemma-style scale; the multiplier is rounded to the model dtype first
    mult = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(dt)
    x = x * float(mult)  # lint: waive TX001 -- a CPU tensor: no sync
    return shard(x, "batch", None, None)


def lm_logits(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ pinned(p["embed"]["tok"]).to(x.dtype).T    # (V, D) weight
    else:
        logits = x @ p["embed"]["head"].to(x.dtype)             # (D, V) weight
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:        # mask vocab-padding columns
        if is_split(logits, -1):
            # the reference's select: a fill of the last columns of a
            # vocabulary split over devices would gather all the logits
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < cfg.vocab_size, logits, -1e30)
        else:
            logits[..., cfg.vocab_size:] = -1e30
    return shard(logits, "batch", None, "model")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32.  logits: (B,S,V); labels: (B,S) int."""
    lf = logits.float()
    if is_split(lf, -1):
        # over a vocabulary split over devices: a max and a sum, each an
        # all-reduce of (B,S), as XLA partitions it (DTensor's logsumexp
        # gathers the logits)
        m = lf.amax(dim=-1, keepdim=True)
        logz = (m + torch.log(torch.exp(lf - m).sum(dim=-1,
                                                    keepdim=True)))[..., 0]
    else:
        logz = torch.logsumexp(lf, dim=-1)
    # on a device mesh the gathered gold logits (a masked partial sum over
    # the vocabulary's shards) are reduced before the select: DTensor's
    # mask does not follow a select
    gold = shard(torch.gather(lf, -1, labels[..., None].long()),
                 "batch", None, None)[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
