"""Gradient compression: int8 quantisation with error feedback.

The twin of ``src/repro/optim/compression.py``: per-tensor symmetric int8 of
``grads + residual``; the optimizer sees the round trip (what the wire would
carry) and the residual ``input - round trip`` carries to the next step.  The
scale's divisions are by tensors on the gradient's device: on a CUDA tensor a
division by a Python number is a multiply by its rounded reciprocal, which
would move codes (``models/attention.py::quantize_kv`` meets the same).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.params import tree_map

Pytree = Any


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_compress_grads(grads: Pytree, err: Pytree) -> Tuple[Pytree, Pytree]:
    """Quantise (grads + err) to int8, return (dequantised grads, new err).

    The returned grads are what the optimizer sees (post round-trip, i.e.
    exactly what the wire carried); new err = input − round-trip.
    """
    out = tree_map(_one, grads, err)               # (round trip, err) leaves
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def _one(g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e
    q, s = compress_int8(gf)
    rt = decompress_int8(q, s)
    return rt.to(g.dtype), gf - rt


def ef_init(params: Pytree, abstract: bool = False) -> Pytree:
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device="meta" if abstract else p.device),
        params)
