"""Block assembly: pattern-cycled layer stacks.

The twin of ``src/repro/models/transformer.py``.  A config's ``block_pattern``
(e.g. ``("local", "global")``) is cycled over ``num_layers``.  Parameters for
each pattern position are *stacked* along a leading repeat axis, as in the
reference (so its parameter tree converts leaf for leaf); where the reference
runs the stack under ``lax.scan``, this runs a Python loop over that axis and
hands each repeat a VIEW of the stacked leaves (no copy).  The non-divisible
remainder runs as a tail.  For training, ``cfg.remat`` wraps each repeat in
``torch.utils.checkpoint`` as the reference wraps it in ``jax.checkpoint``
(``full``; ``selective`` keeps the non-batched products).

Block types: ``global`` and ``local`` with a dense MLP, or, when the config
has experts (``num_experts > 0``), a mixture-of-experts layer
(``models/moe.py``) in its place; ``rglru`` (Griffin recurrence + MLP),
``mamba2`` (SSD, no MLP), ``enc`` (non-causal self-attention + MLP: the
encoder of an encoder-decoder model) and ``xdec`` (causal self-attention,
then cross-attention over the encoder's output, then MLP).  Decode updates
every cache IN PLACE: each block gets a view of its repeat of the stacked
cache and writes its new K/V row or its new recurrent state into it; an
``xdec`` block's cross K/V (``ck`` / ``cv``, made at prefill) are read only.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import shard
from . import attention as attn
from . import griffin, moe, ssm
from .layers import apply_mlp, apply_rmsnorm, dtype_of, init_mlp, init_rmsnorm
from .params import ParamStore, tree_map
from .pipeline import pipeline_stack

BLOCK_TYPES = ("global", "local", "rglru", "mamba2", "enc", "xdec")


def _check_block(cfg: ModelConfig, btype: str):
    if btype not in BLOCK_TYPES:
        raise ValueError(f"unknown block type {btype!r}")


def pattern_of(cfg: ModelConfig, encoder: bool = False) -> Tuple[str, ...]:
    if encoder:
        return ("enc",)
    if cfg.is_encoder_decoder:
        return ("xdec",)
    return cfg.block_pattern


def stack_layout(cfg: ModelConfig, encoder: bool = False
                 ) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repeats, tail_block_types)."""
    pat = pattern_of(cfg, encoder)
    n = cfg.num_encoder_layers if encoder else cfg.num_layers
    reps = n // len(pat)
    tail = pat[: n % len(pat)]
    return pat, reps, tail


def _window(cfg: ModelConfig, btype: str) -> Optional[int]:
    return cfg.window_size if btype == "local" else None


# ---------------------------------------------------------------- block init

def init_block(ps: ParamStore, path: str, cfg: ModelConfig, btype: str,
               stacked: Optional[int]):
    _check_block(cfg, btype)
    D = cfg.d_model
    init_rmsnorm(ps, f"{path}/norm1", D, stacked)
    if btype == "mamba2":                    # no MLP, no norm2
        ssm.init_mamba(ps, f"{path}/mamba", cfg, stacked)
        return
    if btype == "rglru":
        griffin.init_griffin(ps, f"{path}/rec", cfg, stacked)
    else:
        attn.init_attention(ps, f"{path}/attn", cfg, stacked)
        if btype == "xdec":
            init_rmsnorm(ps, f"{path}/normx", D, stacked)
            attn.init_attention(ps, f"{path}/xattn", cfg, stacked)
    init_rmsnorm(ps, f"{path}/norm2", D, stacked)
    if cfg.num_experts > 0 and btype != "rglru":   # the reference's tree
        moe.init_moe(ps, f"{path}/moe", cfg, stacked)
    else:
        init_mlp(ps, f"{path}/mlp", cfg, cfg.d_ff, stacked)


def init_stack(ps: ParamStore, path: str, cfg: ModelConfig,
               encoder: bool = False):
    pat, reps, tail = stack_layout(cfg, encoder)
    for i, bt in enumerate(pat):
        init_block(ps, f"{path}/stack/p{i}", cfg, bt, stacked=reps)
    for j, bt in enumerate(tail):
        init_block(ps, f"{path}/tail/t{j}", cfg, bt, stacked=None)


# ---------------------------------------------------------------- block apply

def _ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + moe.apply_moe(p["moe"], cfg, h, impl=cfg.moe_impl,
                                 group_size=cfg.moe_group_size)
    return x + apply_mlp(p["mlp"], cfg, h)


def _cross(p, cfg: ModelConfig, x: torch.Tensor, kv) -> torch.Tensor:
    """An ``xdec`` block's cross-attention sublayer over encoder K/V ``kv``."""
    h = apply_rmsnorm(p["normx"], x, cfg.norm_eps)
    return x + attn.cross_attention(p["xattn"], cfg, h, kv)


def apply_block(p, cfg: ModelConfig, btype: str, x: torch.Tensor,
                positions: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None):
    """Training forward for one block (``enc_out``: the encoder's output,
    for ``xdec`` blocks)."""
    _check_block(cfg, btype)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if btype == "mamba2":
        return shard(x + ssm.apply_mamba(p["mamba"], cfg, h),
                     "batch", None, None)
    if btype == "rglru":
        x = x + griffin.apply_griffin(p["rec"], cfg, h)
    else:
        x = x + attn.self_attention(p["attn"], cfg, h, positions,
                                    _window(cfg, btype),
                                    causal=btype != "enc")
        if btype == "xdec":
            x = _cross(p, cfg, x, attn.encode_cross_kv(p["xattn"], cfg,
                                                       enc_out))
    return shard(_ffn(p, cfg, x), "batch", None, None)


# ---------------------------------------------------------------- cache

def init_block_cache(cfg: ModelConfig, btype: str, batch: int, max_len: int,
                     device="cuda", enc_len: int = 0) -> Dict:
    """One block's decode cache; an ``xdec`` block's adds the cross K/V of
    ``enc_len`` encoder positions (model dtype, never int8)."""
    _check_block(cfg, btype)
    if btype == "enc":
        raise ValueError("an encoder block keeps no decode cache")
    if btype == "rglru":
        return {"rec": griffin.init_griffin_cache(cfg, batch, device)}
    if btype == "mamba2":
        return {"ssm": ssm.init_mamba_cache(cfg, batch, device)}
    c = {"kv": attn.init_cache(cfg, batch, max_len, _window(cfg, btype),
                               device)}
    if btype == "xdec":
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        c["ck"], c["cv"] = (torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=resolve_device(device))
                            for _ in range(2))
    return c


def prefill_block(p, cfg: ModelConfig, btype: str, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  enc_out: Optional[torch.Tensor] = None):
    """Forward + cache construction (serving prefill)."""
    _check_block(cfg, btype)
    if btype == "enc":
        raise ValueError("an encoder block keeps no decode cache")
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if btype == "mamba2":
        y, mcache = ssm.apply_mamba(p["mamba"], cfg, h, return_cache=True)
        return shard(x + y, "batch", None, None), {"ssm": mcache}
    if btype == "rglru":
        y, rec = griffin.apply_griffin(p["rec"], cfg, h, return_cache=True)
        cache = {"rec": rec}
    else:
        window = _window(cfg, btype)
        y, (k, v) = attn.self_attention(p["attn"], cfg, h, positions, window,
                                        causal=True, return_kv=True)
        cache = {"kv": attn.build_cache_from_prefill(cfg, k, v, max_len,
                                                     window)}
    x = x + y
    if btype == "xdec":
        cache["ck"], cache["cv"] = attn.encode_cross_kv(p["xattn"], cfg,
                                                        enc_out)
        x = _cross(p, cfg, x, (cache["ck"], cache["cv"]))
    return shard(_ffn(p, cfg, x), "batch", None, None), cache


def decode_block(p, cfg: ModelConfig, btype: str, x: torch.Tensor, cache: Dict,
                 pos, plan: Optional[attn.DecodePlan] = None):
    """One decode step of one block; ``cache`` is updated in place."""
    _check_block(cfg, btype)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if btype == "mamba2":
        y, _ = ssm.decode_mamba(p["mamba"], cfg, h, cache["ssm"])
        return x + y, cache
    if btype == "rglru":
        y, _ = griffin.decode_griffin(p["rec"], cfg, h, cache["rec"])
    else:
        y, _ = attn.decode_self_attention(p["attn"], cfg, h, cache["kv"], pos,
                                          _window(cfg, btype), plan)
    x = x + y
    if btype == "xdec":
        x = _cross(p, cfg, x, (cache["ck"], cache["cv"]))
    return _ffn(p, cfg, x), cache


# ---------------------------------------------------------------- stacks

def _repeat(tree, r: int):
    """Repeat ``r`` of a stacked tree: views of the leaves, no copy."""
    return tree_map(lambda a: a[r], tree)


def _save_mm(ctx, op, *args, **kwargs):
    """The ``selective`` policy: keep the outputs of ``aten.mm`` — the
    products with no batch dimension (projections, MLP, logits), what the
    reference's ``dots_with_no_batch_dims_saveable`` keeps — and recompute
    everything else, the attention's batched ``bmm`` included."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: ModelConfig, fn):
    """``cfg.remat`` around one repeat of the block pattern, as the
    reference's ``_remat_wrap``: ``full`` keeps only the repeat's input and
    recomputes the rest in the backward; ``selective`` keeps ``aten.mm``'s
    outputs too (:func:`_save_mm`).  Values do not change."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "selective":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_mm))
    if cfg.remat != "none":
        raise ValueError(f"remat={cfg.remat!r} (none, full, selective)")
    return fn


def apply_stack(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, encoder: bool = False,
                enc_out: Optional[torch.Tensor] = None):
    """Training forward through the whole stack (the encoder's with
    ``encoder=True``); ``cfg.remat`` wraps each repeat of the pattern.  A
    decoder stack with ``cfg.pipeline_stages > 1`` runs as a GPipe pipeline
    (``models/pipeline.py``)."""
    pat, reps, tail = stack_layout(cfg, encoder)

    def one_repeat(x, psl):
        for i, bt in enumerate(pat):
            x = apply_block(psl[f"p{i}"], cfg, bt, x, positions, enc_out)
        return x

    body = _remat_wrap(cfg, one_repeat)
    if reps and cfg.pipeline_stages > 1 and not encoder:
        if tail:
            raise ValueError("pipeline mode: layers % pattern must be 0")
        x = pipeline_stack(params["stack"], cfg, x, positions, body,
                           cfg.pipeline_microbatches)
    else:
        for r in range(reps):
            x = body(x, _repeat(params["stack"], r))
    for j, bt in enumerate(tail):
        x = apply_block(params["tail"][f"t{j}"], cfg, bt, x, positions,
                        enc_out)
    return x


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device="cuda", enc_len: int = 0) -> Dict:
    pat, reps, tail = stack_layout(cfg)
    out: Dict[str, Any] = {"stack": {}, "tail": {}}
    for i, bt in enumerate(pat):
        one = init_block_cache(cfg, bt, batch, max_len, device, enc_len)
        out["stack"][f"p{i}"] = tree_map(
            lambda a: a.new_zeros((reps,) + a.shape), one)
    for j, bt in enumerate(tail):
        out["tail"][f"t{j}"] = init_block_cache(cfg, bt, batch, max_len,
                                                device, enc_len)
    return out


def prefill_stack(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  enc_out: Optional[torch.Tensor] = None):
    pat, reps, tail = stack_layout(cfg)
    cache: Dict[str, Any] = {"stack": {}, "tail": {}}
    slices = []
    for r in range(reps):
        psl = _repeat(params["stack"], r)
        caches = {}
        for i, bt in enumerate(pat):
            x, caches[f"p{i}"] = prefill_block(psl[f"p{i}"], cfg, bt, x,
                                               positions, max_len, enc_out)
        slices.append(caches)
    if slices:
        cache["stack"] = tree_map(lambda *xs: torch.stack(xs), *slices)
    for j, bt in enumerate(tail):
        x, cache["tail"][f"t{j}"] = prefill_block(
            params["tail"][f"t{j}"], cfg, bt, x, positions, max_len, enc_out)
    return x, cache


def decode_stack(params, cfg: ModelConfig, x: torch.Tensor, cache: Dict, pos):
    """One decode step through the stack.

    Each block gets a view of its repeat of the stacked cache and writes its
    new K/V row or recurrent state into it in place, so ``cache`` itself is
    updated and returned (the reference threads the cache through its scan
    carry to the same end)."""
    pat, reps, tail = stack_layout(cfg)
    # positions, RoPE tables and valid masks are the same for every layer
    plan = attn.DecodePlan(cfg, pos, x.shape[0], x.device)
    for r in range(reps):
        psl = _repeat(params["stack"], r)
        for i, bt in enumerate(pat):
            x, _ = decode_block(psl[f"p{i}"], cfg, bt, x,
                                _repeat(cache["stack"][f"p{i}"], r), pos, plan)
    for j, bt in enumerate(tail):
        x, _ = decode_block(params["tail"][f"t{j}"], cfg, bt, x,
                            cache["tail"][f"t{j}"], pos, plan)
    return x, cache
