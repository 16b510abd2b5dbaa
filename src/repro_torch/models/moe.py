"""Mixture-of-Experts: shared + routed experts, top-k routing.

The twin of ``src/repro/models/moe.py``, as plain functions on tensors (the
reference's sharding annotations are dropped).  Two dispatch forms:

* ``onehot`` — GShard/Switch-style capacity dispatch through (G,S,E,C)
  one-hot tensors and einsums.  Dense; its dispatch and combine products grow
  with the group size.
* ``sort`` — the (token, choice) pairs sorted by expert, gathered into
  equal-capacity bins, a batched product per expert, and the weighted outputs
  summed back per token.

Both keep a capacity factor: a (token, choice) pair whose rank among its
expert's pairs, in (token, choice) order, reaches the capacity is dropped,
and its token keeps only its other choices (and the residual stream).  The
router runs in f32.  The top k are taken as the reference's ``lax.top_k``
takes them: descending, the lower expert first on a tie (a stable sort;
``torch.topk`` promises no order on ties, and the order moves both the
capacity slots and the combine).  The products are outside every kernel and
stay ``torch.einsum`` in the model dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import is_split, reshape, shard
from .layers import _act, apply_mlp, init_mlp
from .params import ParamStore

MOE_GROUP_SIZE = 2048      # tokens per routing group
MOE_IMPL = ("onehot", "sort")


def init_moe(ps: ParamStore, path: str, cfg: ModelConfig,
             stacked: Optional[int]):
    D, F_, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    pre = (stacked,) if stacked else ()
    pax = (None,) if stacked else ()
    ps.param(f"{path}/router", pre + (D, E), pax + ("fsdp", None), "fan_in",
             dtype=torch.float32)
    ps.param(f"{path}/w_gate", pre + (E, D, F_), pax + ("expert", "fsdp", None),
             "fan_in")
    ps.param(f"{path}/w_in", pre + (E, D, F_), pax + ("expert", "fsdp", None),
             "fan_in")
    ps.param(f"{path}/w_out", pre + (E, F_, D), pax + ("expert", None, "fsdp"),
             "fan_in")
    if cfg.num_shared_experts:
        init_mlp(ps, f"{path}/shared", cfg,
                 cfg.moe_d_ff * cfg.num_shared_experts, stacked)


def _router_probs(p, cfg: ModelConfig, x: torch.Tensor):
    """(T, E) f32 probabilities + (T, k) top-k indices/weights."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # descending, ties to the lower expert: the reference's lax.top_k
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)   # renormalise
    return probs, topi, topw


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def _experts(p, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """(G, E, C, D) binned tokens -> (G, E, C, D) expert outputs."""
    dt = xe.dtype
    h = _act(cfg, torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))) * \
        torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(dt))
    return torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))


# ---------------------------------------------------------------- onehot path

def _moe_onehot(p, cfg: ModelConfig, xg: torch.Tensor) -> torch.Tensor:
    """xg: (G, S, D) grouped tokens -> (G, S, D)."""
    G, S, D = xg.shape
    E, k = cfg.num_experts, cfg.top_k
    C = _capacity(S, cfg)
    dt = xg.dtype

    _, topi, topw = _router_probs(p, cfg, reshape(xg, (G * S, D)))
    topi = reshape(topi, (G, S, k))
    topw = reshape(topw, (G, S, k))

    # position of each (token, choice) within its expert's capacity
    onehot = F.one_hot(topi, E)                                   # (G,S,k,E)
    flat = reshape(onehot, (G, S * k, E))   # lexicographic (token, choice)
    pos4 = reshape(flat.cumsum(1) - flat, (G, S, k, E))

    # dispatch/combine (G,S,E,C) accumulated per choice, as the reference
    disp = xg.new_zeros((G, S, E, C))
    comb = torch.zeros((G, S, E, C), dtype=torch.float32, device=xg.device)
    for kk in range(k):
        oh_e = onehot[:, :, kk, :]                                # (G,S,E)
        slot = (pos4[:, :, kk, :] * oh_e).sum(-1)                 # (G,S)
        keep = (slot < C).float()
        oh_c = F.one_hot(slot.clamp(max=C - 1), C).float() * keep[..., None]
        d = oh_e.float()[..., None] * oh_c[:, :, None, :]
        disp = disp + d.to(dt)
        comb = comb + d * topw[:, :, kk, None, None]

    xe = torch.einsum("gsec,gsd->gecd", disp, xg)                 # (G,E,C,D)
    xe = shard(xe, "batch", "expert", None, None)
    ye = shard(_experts(p, cfg, xe), "batch", "expert", None, None)
    if is_split(ye, 1):
        # experts split over devices: the same contraction as one product
        # over (e, c) (some DTensor versions cannot flatten the einsum's
        # permuted operands)
        return reshape(comb.to(dt), (G, S, E * C)) @ \
            reshape(ye, (G, E * C, D))
    return torch.einsum("gsec,gecd->gsd", comb.to(dt), ye)


# ---------------------------------------------------------------- sort path

def _moe_sort(p, cfg: ModelConfig, xg: torch.Tensor) -> torch.Tensor:
    """Sort-based routing: (G,S,D) -> (G,S,D) with no dispatch products.

    The reference scatter-adds each kept pair's ``w·y`` into an f32 (S, D);
    on the card that add would be atomic, its order free, its bits not
    repeatable.  Each token has exactly k pairs, so they are gathered per
    token instead and summed in one fixed order: increasing expert id, the
    order the reference's scatter walks the sorted pairs."""
    G, S, D = xg.shape
    E, k = cfg.num_experts, cfg.top_k
    C = _capacity(S, cfg)
    dev = xg.device

    _, topi, topw = _router_probs(p, cfg, reshape(xg, (G * S, D)))
    eid = reshape(topi, (G, S * k))              # (token, choice) order
    w = reshape(topw, (G, S * k))
    order = torch.argsort(eid, dim=-1, stable=True)             # by expert
    eid_s = eid.gather(1, order)
    tok_s = order // k
    # slot within expert = rank - first rank of the expert
    first = torch.searchsorted(eid_s, torch.arange(E, device=dev)
                               .expand(G, E).contiguous())
    slot = torch.arange(S * k, device=dev) - first.gather(1, eid_s)
    keep = slot < C
    dest = eid_s * C + slot.clamp(max=C - 1)
    # gather the kept tokens into (E*C, D) bins; a kept pair's bin is its
    # own, the dropped ones go to a spare row past the bins
    xs = xg.gather(1, tok_s[..., None].expand(G, S * k, D))
    xbin = xg.new_zeros((G, E * C + 1, D))
    xbin.scatter_(1, torch.where(keep, dest, E * C)[..., None]
                  .expand(G, S * k, D), xs)
    ybin = _experts(p, cfg, xbin[:, :E * C].reshape(G, E, C, D))
    ybin = ybin.reshape(G, E * C, D)
    # each token's k pairs by their places in the sorted order (the inverse
    # permutation), ascending: increasing expert id
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * k, device=dev).expand(G, S * k)
        .contiguous())
    pos = pos.reshape(G, S, k).sort(-1).values.reshape(G, S * k)
    wk = torch.where(keep, w.gather(1, order), 0.0).gather(1, pos)
    yk = ybin.gather(1, dest.gather(1, pos)[..., None].expand(G, S * k, D))
    yk = (wk[..., None] * yk.float()).reshape(G, S, k, D)
    y = yk[:, :, 0]
    for j in range(1, k):
        y = y + yk[:, :, j]
    return y.to(xg.dtype)


# ---------------------------------------------------------------- public API

def apply_moe(p, cfg: ModelConfig, x: torch.Tensor, impl: str = "onehot",
              group_size: int = MOE_GROUP_SIZE) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Routed experts + optional shared experts.
    Tokens route in groups of ``min(group_size, B·S)``, which must divide
    B·S (``ValueError``, the reference's assertion)."""
    B, S, D = x.shape
    T = B * S
    gs = min(group_size, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"tokens {T} not divisible by group size {gs}")
    xg = shard(reshape(x, (G, gs, D)), "batch", None, None)
    if impl == "onehot":
        y = _moe_onehot(p, cfg, xg)
    elif impl == "sort":
        y = _moe_sort(p, cfg, xg)
    else:
        raise ValueError(f"moe impl {impl!r}")
    # the combine's partial sum over split experts reduced at once
    y = shard(reshape(y, (B, S, D)), "batch", None, None)
    if cfg.num_shared_experts:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y
