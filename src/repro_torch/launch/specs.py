"""Abstract stand-ins + partition specs for every model input.

The twin of ``src/repro/launch/specs.py``.  The stand-ins are tensors on the
``meta`` device (shape and dtype, no storage), where the reference uses
``jax.ShapeDtypeStruct``; the dry-run runs a step on them.  Nothing here
allocates device memory.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import Model
from ..models.layers import dtype_of
from ..sharding import P, logical_to_pspec

SEAMLESS_DECODE_ENC_LEN = 4096     # encoder length backing decode-shape cells
SEAMLESS_PREFILL_PROMPT = 64      # decoder prompt tokens during prefill

META = torch.device("meta")


def _bt(*axes):
    return logical_to_pspec(axes)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, P]]:
    """(meta tensors, partition specs) for the data batch."""
    B, S = shape.global_batch, shape.seq_len
    i32, act = torch.int32, dtype_of(cfg)
    sds: Dict[str, Any] = {}
    ps: Dict[str, Any] = {}

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            n = cfg.num_prefix_tokens
            sds["patch_embeds"] = _sds((B, n, cfg.d_model), act)
            ps["patch_embeds"] = _bt("batch", None, None)
            sds["tokens"] = _sds((B, S - n), i32)
        elif cfg.frontend == "audio":
            sds["frames"] = _sds((B, S, cfg.d_model), act)
            ps["frames"] = _bt("batch", None, None)
            dec = SEAMLESS_PREFILL_PROMPT if shape.kind == "prefill" else S
            sds["tokens"] = _sds((B, dec), i32)
        else:
            sds["tokens"] = _sds((B, S), i32)
        ps["tokens"] = _bt("batch", None)
        if shape.kind == "train":
            sds["labels"] = _sds(tuple(sds["tokens"].shape), i32)
            ps["labels"] = _bt("batch", None)
    else:                                   # decode
        sds["tokens"] = _sds((B, 1), i32)
        ps["tokens"] = _bt("batch", None)
    return sds, ps


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def enc_len_of(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Encoder positions a decode cell's cross K/V hold (0 without an
    encoder)."""
    return (min(shape.seq_len, SEAMLESS_DECODE_ENC_LEN)
            if cfg.is_encoder_decoder else 0)


def cache_specs(model: Model, shape: ShapeConfig) -> Tuple[Any, Any]:
    """(cache tree on ``meta``, spec tree).  Batch dim is index 1 for
    stacked leaves ('stack' subtree), else index 0."""
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=META,
                             enc_len=enc_len_of(model.cfg, shape))

    def spec_for(path, leaf):
        keys = set(path)
        bdim = 1 if "stack" in keys else 0
        axes = [None] * leaf.ndim
        axes[bdim] = "kv_batch"
        # KV caches (B, L, KV, Dh): KV heads are often too few to split, so
        # the SEQUENCE dim takes the otherwise-idle `model` axis
        if ({"kv", "ck", "cv"} & keys) and leaf.ndim >= bdim + 4:
            axes[bdim + 1] = "model"
        return logical_to_pspec(axes)

    return cache, _map_with_path(spec_for, cache)


def named(mesh, tree):
    """Spec tree -> tree of (mesh, spec) pairs, the twin of the reference's
    ``NamedSharding`` tree."""
    if isinstance(tree, P):
        return mesh, tree
    return {k: named(mesh, v) for k, v in tree.items()}
