"""Attention: MHA/GQA/MQA with RoPE, causal/sliding-window masks, softcap and
KV caches (full, or a ring buffer for local layers).

The twin of ``src/repro/models/attention.py``.  Projections are stored
flattened — wq: (D, H·Dh), wk/wv: (D, KV·Dh), wo: (H·Dh, D) — and heads are
reshaped locally, as in the reference.

Two execution paths, chosen by ``cfg.attn_impl``:
  * ``cuda``   — the hand-written kernels of ``repro_torch.kernels`` (the twin
    of the reference's ``pallas``); on a CPU tensor their plain versions;
  * ``einsum`` — the plain reference path (logits in the input dtype, softmax
    in f32, probabilities cast back before ``@ v``).

Not ported yet (they raise ``NotImplementedError``; ROADMAP.md queue 1): the
``blocked`` / ``blocked_unroll`` context-parallel forms, the int8 KV cache and
cross-attention.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from .layers import apply_rope, dtype_of, rope_tables
from .params import ParamStore

ATTN_IMPLS = ("cuda", "einsum")


def _check_cfg(cfg: ModelConfig):
    if cfg.attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported (have {ATTN_IMPLS}); "
            "the blocked/context-parallel forms are ROADMAP.md queue 1, "
            "'models/attention.py: what the first slice left out'")
    if cfg.kv_cache_dtype != "model":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported; the int8 "
            "KV cache is ROADMAP.md queue 1, 'models/attention.py: what the "
            "first slice left out'")


def init_attention(ps: ParamStore, path: str, cfg: ModelConfig,
                   stacked: Optional[int]):
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre = (stacked,) if stacked else ()
    ps.param(f"{path}/wq", pre + (D, H * Dh), "fan_in")
    ps.param(f"{path}/wk", pre + (D, KV * Dh), "fan_in")
    ps.param(f"{path}/wv", pre + (D, KV * Dh), "fan_in")
    ps.param(f"{path}/wo", pre + (H * Dh, D), "fan_in")


def _proj(x: torch.Tensor, w: torch.Tensor, heads: int,
          head_dim: int) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    return y.reshape(*y.shape[:-1], heads, head_dim)


def _unproj(y: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return y.reshape(*y.shape[:-2], -1) @ w.to(dtype)


def _attend_einsum(q, k, v, mask, softcap, scale):
    """Grouped-query attention without materialising repeated KV.

    q: (B,Sq,H,Dh); k,v: (B,Sk,KV,Dh); H = KV·groups.
    mask: (1|B, 1, Sq, Sk) or None.  Returns (B,Sq,H,Dh).
    """
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    logits = logits.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


def make_causal_mask(sq: int, sk: int, q_offset, window: Optional[int],
                     device=None):
    """(1,1,Sq,Sk) bool; window=None => full causal, else sliding window."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


def self_attention(p, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   causal: bool = True, return_kv: bool = False):
    """Training/prefill self-attention over the whole (possibly windowed) seq."""
    _check_cfg(cfg)
    B, S, D = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tables = rope_tables(positions, Dh, cfg.rope_theta)
    q = apply_rope(_proj(x, p["wq"], H, Dh), positions, cfg.rope_theta, tables)
    k = apply_rope(_proj(x, p["wk"], KV, Dh), positions, cfg.rope_theta, tables)
    v = _proj(x, p["wv"], KV, Dh)
    scale = Dh ** -0.5

    if cfg.attn_impl == "cuda" and causal:
        from ..kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap, scale=scale)
    else:
        mask = make_causal_mask(S, S, 0, window, x.device) if causal else None
        out = _attend_einsum(q, k, v, mask, cfg.attn_softcap, scale)
    y = _unproj(out, p["wo"], x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def cross_attention(p, cfg: ModelConfig, x, enc_kv):
    raise NotImplementedError(
        "cross_attention (encoder-decoder models) is not ported; ROADMAP.md "
        "queue 1, 'models/attention.py: what the first slice left out'")


# ---------------------------------------------------------------- KV cache

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], device="cuda") -> Dict:
    """One layer's KV cache.  Local layers get a ring buffer of window size."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    L = min(max_len, window) if window is not None else max_len
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def build_cache_from_prefill(cfg: ModelConfig, k: torch.Tensor,
                             v: torch.Tensor, max_len: int,
                             window: Optional[int]) -> Dict:
    """Arrange prefill K/V into the decode cache layout.

    Full cache: positions [0, S) land at slots [0, S).  Ring buffer: the last
    ``min(S, W)`` positions land at slot = position % W (so decode writes
    continue seamlessly).
    """
    _check_cfg(cfg)
    B, S = k.shape[0], k.shape[1]
    if window is None:
        L = max_len
        if L == S:
            ck, cv = k, v                      # prefill to the brim: no pad
        else:
            ck = k.new_zeros((B, L) + k.shape[2:])
            cv = v.new_zeros((B, L) + v.shape[2:])
            ck[:, :S] = k
            cv[:, :S] = v
    else:
        L = min(max_len, window)
        n = min(S, L)
        slots = torch.arange(S - n, S, device=k.device) % L
        ck = k.new_zeros((B, L) + k.shape[2:])
        cv = v.new_zeros((B, L) + v.shape[2:])
        ck[:, slots] = k[:, S - n:]
        cv[:, slots] = v[:, S - n:]
    return {"k": ck, "v": cv}


class DecodePlan:
    """What every layer of ONE decode tick shares, computed once: the per-slot
    positions, their RoPE tables, and for each kind of cache (full, or a ring
    of some length) the slot written and the ``valid`` mask.  The reference
    recomputes these in every layer and leaves it to XLA to merge them; eager
    PyTorch would pay for each copy."""

    def __init__(self, cfg: ModelConfig, pos, batch: int, device):
        self.posb = torch.as_tensor(pos, device=device).to(torch.int64) \
            .reshape(-1)[:, None].expand(batch, 1)                # (B,1)
        self.tables = rope_tables(self.posb, cfg.head_dim, cfg.rope_theta)
        self.rows = torch.arange(batch, device=device)
        self._by_cache = {}

    def slot_valid(self, window: Optional[int], L: int):
        """(slot (B,), valid (B,L)) for a cache of length L."""
        key = (window, L)
        if key not in self._by_cache:
            posb = self.posb
            idx = torch.arange(L, device=posb.device)[None, :]    # (1,L)
            # valid slots: a ring holds positions (pos-L, pos]; a full cache
            # those <= pos.  torch.remainder follows the sign of the divisor,
            # as the reference's mod does.
            if window is not None:
                slot = torch.remainder(posb, L)
                slot_pos = posb - torch.remainder(slot - idx, L)  # stored pos
                valid = (slot_pos >= 0) & (slot_pos > posb - window)
            else:
                slot = posb
                valid = idx <= posb
            self._by_cache[key] = (slot[:, 0], valid)
        return self._by_cache[key]


def decode_self_attention(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                          pos, window: Optional[int],
                          plan: Optional[DecodePlan] = None):
    """One-token decode: update cache at ``pos``, attend over it.

    x: (B, 1, D); pos: an int, a scalar tensor OR a per-slot (B,) vector
    (continuous batching serves requests at different positions in one tick).
    Ring-buffer writes for local layers keep the cache O(window).  ``plan``:
    the tick's :class:`DecodePlan` if the caller made one (``decode_stack``
    does, for all its layers); otherwise it is made here from ``pos``.

    The reference rewrites the whole cache through a ``where`` (a workaround
    for its SPMD partitioner); here the one new row of each slot is written
    IN PLACE into ``cache`` and the same tensors are returned.
    """
    _check_cfg(cfg)
    B, _, D = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    if plan is None:
        plan = DecodePlan(cfg, pos, B, x.device)
    # one rotation for the q and k heads together (fewer small launches);
    # q and k are then views, which the kernel reads through their strides
    qk = torch.cat([_proj(x, p["wq"], H, Dh), _proj(x, p["wk"], KV, Dh)], dim=2)
    qk = apply_rope(qk, plan.posb, cfg.rope_theta, plan.tables)
    q, k = qk[:, :, :H], qk[:, :, H:]
    v = _proj(x, p["wv"], KV, Dh)

    ck, cv = cache["k"], cache["v"]
    slot, valid = plan.slot_valid(window, ck.shape[1])
    ck[plan.rows, slot] = k[:, 0].to(ck.dtype)
    cv[plan.rows, slot] = v[:, 0].to(cv.dtype)

    if cfg.attn_impl == "cuda":
        from ..kernels import ops as kops
        out = kops.decode_attention(q, ck.to(dt), cv.to(dt), valid,
                                    softcap=cfg.attn_softcap,
                                    scale=Dh ** -0.5)
    else:
        mask = valid[:, None, None, :]                            # (B,1,1,L)
        out = _attend_einsum(q, ck.to(dt), cv.to(dt), mask,
                             cfg.attn_softcap, Dh ** -0.5)
    y = _unproj(out, p["wo"], dt)
    return y, {"k": ck, "v": cv}
