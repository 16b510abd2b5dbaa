"""Attention: MHA/GQA/MQA with RoPE, causal/sliding-window masks, softcap,
KV caches (full, or a ring buffer for local layers; in the model dtype or
int8 with per-(token, head) scales) and cross-attention.

The twin of ``src/repro/models/attention.py``.  Projections are stored
flattened — wq: (D, H·Dh), wk/wv: (D, KV·Dh), wo: (H·Dh, D) — and heads are
reshaped locally, as in the reference.

Execution paths, chosen by ``cfg.attn_impl``:
  * ``cuda``   — the hand-written kernels of ``repro_torch.kernels`` (the twin
    of the reference's ``pallas``) for causal self-attention and decode; on
    a CPU tensor their plain versions;
  * ``einsum`` — the plain reference path (logits in the input dtype, softmax
    in f32, probabilities cast back before ``@ v``);
  * ``blocked`` / ``blocked_unroll`` — :func:`_attend_blocked`, query chunks
    against the key range they need.  The reference's context-parallel
    ``shard_map`` form of global layers falls back to this on one device
    (chunks of 512; windowed layers 1024), so on one card the two names are
    the same function.  Decode runs the einsum path under both, as in the
    reference.  On a device mesh (the dry-run's partitioned count) a layer
    whose queries are split over the sequence takes :func:`_attend_cp`, the
    reference's context-parallel form of unbounded layers.

Activations carry the reference's layout constraints (``sharding.shard``,
no-ops without a device mesh), and reshapes that split heads go through
``sharding.reshape``, which on a device mesh gathers a split the reshape
cannot keep.

Non-causal attention (the encoder) and cross-attention run the einsum path
under every name: the reference calls its kernels for causal attention only.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import is_split, mesh_axis, reshape, shard
from .layers import apply_rope, dtype_of, rope_tables
from .params import ParamStore

ATTN_IMPLS = ("cuda", "einsum", "blocked", "blocked_unroll")
# query rows a chunk of _attend_blocked: global layers (the one-device
# fallback of the reference's _attend_cp), windowed layers
BLOCKED_CHUNK = {"global": 512, "window": 1024}


def _check_cfg(cfg: ModelConfig):
    if cfg.attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not one of the port's {ATTN_IMPLS}"
            " (the reference's 'pallas' kernels are 'cuda' here)")


def _kv_int8(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_dtype == "int8"


def shard_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sequence-shard an activation over the ``q_seq`` axis when divisible
    (the reference's: head counts like 36/10/8 do not divide a 16-way model
    axis; the sequence always does)."""
    _, size = mesh_axis("q_seq")
    if size > 1 and x.shape[dim] % size == 0 and x.shape[dim] > 1:
        axes = [None] * x.ndim
        axes[0] = "batch"
        axes[dim] = "q_seq"
        return shard(x, *axes)
    return x


def init_attention(ps: ParamStore, path: str, cfg: ModelConfig,
                   stacked: Optional[int]):
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre = (stacked,) if stacked else ()
    pax = (None,) if stacked else ()
    ps.param(f"{path}/wq", pre + (D, H * Dh), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/wk", pre + (D, KV * Dh), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/wv", pre + (D, KV * Dh), pax + ("fsdp", "model"), "fan_in")
    ps.param(f"{path}/wo", pre + (H * Dh, D), pax + ("model", "fsdp"), "fan_in")


def _proj(x: torch.Tensor, w: torch.Tensor, heads: int,
          head_dim: int) -> torch.Tensor:
    y = shard(x @ w.to(x.dtype), "batch", None, "model")
    return reshape(y, (*y.shape[:-1], heads, head_dim))


def _unproj(y: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    yf = shard(y.reshape(*y.shape[:-2], -1), "batch", None, "model")
    # the output's partial sum over the split heads reduced at once (no-op
    # without a device mesh), as the block's output constraint would
    return shard(yf @ w.to(dtype), "batch", None, None)


def _attend_einsum(q, k, v, mask, softcap, scale):
    """Grouped-query attention without materialising repeated KV.

    q: (B,Sq,H,Dh); k,v: (B,Sk,KV,Dh); H = KV·groups.
    mask: (1|B, 1, Sq, Sk) or None.  Returns (B,Sq,H,Dh).
    """
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = reshape(q, (B, Sq, KV, g, Dh))
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    logits = logits.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


def _attend_blocked(q, k, v, *, causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float,
                    chunk: int = 1024, scores_f32: bool = True):
    """Blocked attention in plain torch: query chunks of ``chunk`` rows, each
    against the key range it can see (causal: up to its last row; a window:
    from ``k_lo``, rounded down to a multiple of 128), masked with -1e30
    and softmaxed whole (no online softmax).  Scores in f32, or in the input
    dtype when ``scores_f32`` is False.  q: (B,Sq,H,Dh); k,v: (B,Sk,KV,Dh).
    """
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    # on a device mesh: q, k and v whole over the sequence before the chunks
    # slice them (one gather each, not one a chunk); no-ops otherwise
    q, k, v = (shard(t, "batch", None, None, None) for t in (q, k, v))
    qg = reshape(q, (B, Sq, KV, H // KV, Dh))
    chunk = min(chunk, Sq)
    outs = []
    for i0 in range(0, Sq, chunk):
        i1 = min(i0 + chunk, Sq)
        k_hi = min(i1, Sk) if causal else Sk
        k_lo = 0
        if window is not None:
            k_lo = max(0, ((i0 - window + 1) // 128) * 128)
        qs = shard(qg[:, i0:i1], "batch", "q_seq", None, None, None)
        s = torch.einsum("bqkgd,bskd->bkgqs", qs, k[:, k_lo:k_hi]) * scale
        s = s.to(torch.float32 if scores_f32 else q.dtype)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        rows = i0 + torch.arange(i1 - i0, device=q.device)[:, None]
        cols = k_lo + torch.arange(k_hi - k_lo, device=q.device)[None, :]
        m = torch.ones((i1 - i0, k_hi - k_lo), dtype=torch.bool,
                       device=q.device)
        if causal:
            m &= cols <= rows
        if window is not None:
            m &= cols > rows - window
        s = torch.where(m, s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k_lo:k_hi])
        outs.append(shard(o, "batch", "q_seq", None, None, None))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, Dh)


def _attend_cp_local(q, k, v, *, row0: int, causal: bool,
                     window: Optional[int], softcap: Optional[float],
                     scale: float, chunk: int, scores_f32: bool):
    """One device's part of context-parallel attention: its query rows (the
    first global row is ``row0``) in chunks against the whole K/V, the causal
    (and window) mask applied against all of K (no early exit), as the
    reference's ``_attend_cp`` body.  q: (B,S_loc,H,Dh); k,v: (B,Sk,KV,Dh)."""
    B, S_loc, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S_loc, KV, H // KV, Dh)
    cols = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for c0 in range(0, S_loc, chunk):
        c1 = min(c0 + chunk, S_loc)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, c0:c1], k) * scale
        s = s.to(torch.float32 if scores_f32 else q.dtype)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        rows = row0 + torch.arange(c0, c1, device=q.device)[:, None]
        if causal:
            s = torch.where(cols <= rows, s, -1e30)
        if window is not None:
            s = torch.where(cols > rows - window, s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, v))
    return torch.cat(outs, dim=1).reshape(B, S_loc, H, Dh)


def _attend_cp(q, k, v, *, causal: bool, window: Optional[int],
               softcap: Optional[float], scale: float, chunk: int,
               scores_f32: bool):
    """Context-parallel attention on a device mesh, the twin of the
    reference's ``shard_map`` form of unbounded layers (here windowed ones
    too: their chunks' reshards would hand DTensor einsums over a split it
    cannot flatten): q stays split over the sequence, K and V are gathered
    whole over that axis once (their gradients reduce-scattered back), and
    each device attends its own rows (``local_map``,
    :func:`_attend_cp_local`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    seq = [i for i, pl in enumerate(q.placements) if pl == Shard(1)]
    mesh = q.device_mesh
    q_pl = tuple(q.placements)
    kv_pl = tuple(Replicate() if i in seq else pl for i, pl in enumerate(q_pl))
    kv_grad = tuple(Partial() if i in seq else pl for i, pl in enumerate(q_pl))
    S_loc = q.shape[1] // math.prod(mesh.size(i) for i in seq)
    rank = 0
    for i in seq:
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
    body = functools.partial(_attend_cp_local, row0=rank * S_loc,
                             causal=causal, window=window, softcap=softcap,
                             scale=scale,
                             chunk=min(chunk, S_loc), scores_f32=scores_f32)
    return local_map(body, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     redistribute_inputs=True)(q, k, v)


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
    q = shard_seq(_proj(x, p["wq"], H, Dh))
    k = shard_seq(_proj(x, p["wk"], KV, Dh))
    v = shard_seq(_proj(x, p["wv"], KV, Dh))
    q = shard_seq(apply_rope(q, positions, cfg.rope_theta, tables))
    k = shard_seq(apply_rope(k, positions, cfg.rope_theta, tables))
    scale = Dh ** -0.5

    if cfg.attn_impl == "cuda" and causal:
        from ..kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap, scale=scale)
    elif cfg.attn_impl in ("blocked", "blocked_unroll"):
        chunk = BLOCKED_CHUNK["global" if window is None else "window"]
        # queries split over the sequence (a device mesh): the reference's
        # condition for its context-parallel form
        attend = _attend_cp if is_split(q, 1) else _attend_blocked
        out = attend(q, k, v, causal=causal, window=window,
                     softcap=cfg.attn_softcap, scale=scale, chunk=chunk,
                     scores_f32=cfg.attn_scores_f32)
    else:
        mask = make_causal_mask(S, S, 0, window, x.device) if causal else None
        out = _attend_einsum(q, k, v, mask, cfg.attn_softcap, scale)
    y = _unproj(shard_seq(out), p["wo"], x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder->encoder attention; enc_kv are precomputed (B,Se,KV,Dh).  No
    mask and no softcap, whatever ``cfg.attn_softcap`` says (the
    reference's)."""
    H, Dh = cfg.num_heads, cfg.head_dim
    q = _proj(x, p["wq"], H, Dh)
    k, v = enc_kv
    out = _attend_einsum(q, k.to(x.dtype), v.to(x.dtype), None, None,
                         Dh ** -0.5)
    return _unproj(out, p["wo"], x.dtype)


def encode_cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor):
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return _proj(enc_out, p["wk"], KV, Dh), _proj(enc_out, p["wv"], KV, Dh)


# ---------------------------------------------------------------- KV cache

def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8.  x: (..., Dh) -> (q, scale(...,1)).
    The scale is computed and applied in f32; only the stored scale is bf16.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  127 is a
    tensor on x's device: a CUDA tensor divided by a Python number is
    multiplied by its rounded reciprocal instead, which moves codes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], device="cuda") -> Dict:
    """One layer's KV cache.  Local layers get a ring buffer of window size.
    ``kv_cache_dtype='int8'`` stores quantised K/V and per-(token, head) bf16
    scales."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    L = min(max_len, window) if window is not None else max_len
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    if _kv_int8(cfg):
        sshape = shape[:-1] + (1,)
        spec = {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (sshape, torch.bfloat16),
                "v_scale": (sshape, torch.bfloat16)}
    else:
        spec = {"k": (shape, dtype_of(cfg)), "v": (shape, dtype_of(cfg))}
    return {name: torch.zeros(shp, dtype=dt, device=dev)
            for name, (shp, dt) in spec.items()}


def _ring(t: torch.Tensor, S: int, L: int) -> torch.Tensor:
    """The ring buffer of length L after a prefill of S positions, as a new
    tensor (no scatter: on a device mesh a scatter into a split cache has no
    layout that keeps it): positions S-n..S-1 (n = min(S, L)) at slots
    (S-n+i) % L, a rotation by S % L when n = L, the first S slots and
    zeros when S < L."""
    last = t[:, S - min(S, L):]
    if S < L:
        return torch.cat([last, last.new_zeros((t.shape[0], L - S)
                                               + tuple(t.shape[2:]))], dim=1)
    r = S % L
    if r == 0:
        return last.clone(memory_format=torch.contiguous_format)
    return torch.cat([last[:, L - r:], last[:, :L - r]], dim=1)


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
        ck, cv = _ring(k, S, L), _ring(v, S, L)
    if _kv_int8(cfg):
        # the whole arranged cache, padding rows included (scale 1e-6/127)
        kq, ks = quantize_kv(ck)
        vq, vs = quantize_kv(cv)
        out = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        out = {"k": ck, "v": cv}
    # the cache sequence-sharded, as the decode cache is laid out
    return {kk: shard(vv, "kv_batch", "kv_seq", None, None)
            for kk, vv in out.items()}


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


def _write_slots(cache_t: torch.Tensor, rows: torch.Tensor,
                 slot: torch.Tensor, new: torch.Tensor):
    """``cache_t[rows, slot] = new`` (one row a batch slot), in place.  A
    cache split over its batch or sequence on a device mesh takes the rows
    through the reference's select (a scatter into it has no layout that
    keeps the cache's), then copied into the cache."""
    if not is_split(cache_t, 0, 1):
        cache_t[rows, slot] = new
        return
    L = cache_t.shape[1]
    sel = torch.arange(L, device=slot.device)[None, :] == slot[:, None]
    sel = sel.reshape(sel.shape + (1,) * (cache_t.ndim - 2))
    cache_t.copy_(torch.where(sel, new[:, None].to(cache_t.dtype), cache_t))


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
    IN PLACE into ``cache`` and the same tensors are returned.  An int8 cache
    takes the quantised row and its scale, and the whole cache is
    dequantised to the model dtype before attention, as in the reference.
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

    slot, valid = plan.slot_valid(window, cache["k"].shape[1])
    if _kv_int8(cfg):
        for name, new in (("k", k), ("v", v)):
            q8, scale = quantize_kv(new[:, 0])
            _write_slots(cache[name], plan.rows, slot, q8)
            _write_slots(cache[f"{name}_scale"], plan.rows, slot, scale)
        ck = dequantize_kv(cache["k"], cache["k_scale"], dt)
        cv = dequantize_kv(cache["v"], cache["v_scale"], dt)
    else:
        _write_slots(cache["k"], plan.rows, slot, k[:, 0].to(cache["k"].dtype))
        _write_slots(cache["v"], plan.rows, slot, v[:, 0].to(cache["v"].dtype))
        ck, cv = cache["k"].to(dt), cache["v"].to(dt)
    ck = shard(ck, "kv_batch", "kv_seq", None, None)
    cv = shard(cv, "kv_batch", "kv_seq", None, None)

    if cfg.attn_impl == "cuda":
        from ..kernels import ops as kops
        out = kops.decode_attention(q, ck, cv, valid,
                                    softcap=cfg.attn_softcap,
                                    scale=Dh ** -0.5)
    else:
        mask = valid[:, None, None, :]                            # (B,1,1,L)
        out = _attend_einsum(q, ck, cv, mask, cfg.attn_softcap, Dh ** -0.5)
    y = _unproj(out, p["wo"], dt)
    return y, cache
