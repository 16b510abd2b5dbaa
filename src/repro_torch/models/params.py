"""Parameter store: one declaration -> tensors or shapes.

The twin of ``src/repro/models/params.py``: model init code declares every
parameter once (path, shape, init) and the store materialises a nested dict of
tensors under the reference's path strings, or — ``abstract=True`` — tensors on
the ``meta`` device that carry shape and dtype but no storage.  Random numbers
come from an explicit ``torch.Generator``; they do not equal the reference's
``jax.random`` draws, so comparisons with the reference convert its tree with
:func:`from_jax_params` instead.  Each declaration also records its logical
axes (``logical``) and their :class:`~repro_torch.sharding.P` under the
installed rules (``specs``), under the same paths, as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..sharding import logical_to_pspec


def _set_path(tree: Dict, path: str, leaf: Any) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    assert parts[-1] not in tree, f"duplicate param {path}"
    tree[parts[-1]] = leaf


class ParamStore:
    """Collects parameter declarations during a model's ``init`` walk."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device="cuda", abstract: bool = False):
        self.generator = generator
        self.dtype = dtype
        self.abstract = abstract
        self.device = torch.device("meta") if abstract \
            else resolve_device(device)
        self.params: Dict = {}
        self.specs: Dict = {}
        self.logical: Dict = {}

    def param(self, path: str, shape: Sequence[int],
              axes: Sequence[Optional[str]], init: str = "normal",
              scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None):
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"{path}: axes {axes} vs shape {shape}")
        dt = dtype or self.dtype
        if self.abstract:
            leaf = torch.empty(shape, dtype=dt, device="meta")
        elif init in ("normal", "fan_in"):
            if init == "normal":
                s = scale if scale is not None else 0.02
            else:
                fan = max(shape[0] if len(shape) == 1
                          else math.prod(shape[:-1]), 1)
                s = (scale if scale is not None else 1.0) / math.sqrt(fan)
            leaf = torch.randn(shape, generator=self.generator,
                               dtype=torch.float32, device=self.device)
            leaf = leaf.mul_(s).to(dt)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dt, device=self.device)
        elif init == "ones":
            leaf = torch.ones(shape, dtype=dt, device=self.device)
        else:
            raise ValueError(f"unknown init {init!r}")
        _set_path(self.params, path, leaf)
        _set_path(self.specs, path, logical_to_pspec(axes))
        _set_path(self.logical, path, tuple(axes))
        return leaf


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def from_jax_params(tree, device="cuda", dtype: Optional[torch.dtype] = None):
    """The reference's parameter tree, as nested dicts of NUMPY arrays, ->
    the port's tree, leaf for leaf under the same paths.

    The caller converts first (``jax.tree.map(np.asarray, params)``); this
    module never sees a ``jax.Array``.  bf16 leaves arrive as
    ``ml_dtypes.bfloat16`` arrays, which torch cannot take: they go through
    float32 (exact) and are cast back on the torch side.  ``dtype=None`` keeps
    each leaf's own dtype; otherwise every floating leaf is cast to ``dtype``.
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))          # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree)
