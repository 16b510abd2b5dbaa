"""Step functions: train (fwd+bwd+AdamW), prefill, decode — the units the
training loop runs.

The twin of ``src/repro/launch/steps.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; the optimizer runs under
``torch.no_grad()``.  A step takes its batch as numpy arrays or tensors and
moves them to the parameters' device.

``make_train_step`` options:
  * ``accum_steps`` — microbatch gradient accumulation (the reference's
    ``lax.scan`` is a Python loop over the microbatches in the same order,
    with accumulators in ``accum_dtype``; a memory lever at fixed global
    batch);
  * ``compress_grads`` — int8 error-feedback gradient compression applied to
    the gradient tree before the optimizer (the EF residual lives in
    ``opt_state["err"]``).

On ``DTensor`` parameters over a device mesh (the dry-run's partitioned
count) each gradient is redistributed to its parameter's layout as it is
taken: the data-parallel reduction, before the optimizer's in-place update.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models import Model
from ..models.params import tree_leaves, tree_map
from ..optim import (AdamWConfig, adamw_init, adamw_update, ef_compress_grads,
                     ef_init)
from ..sharding import like_param, reshape, shard

Pytree = Any


def init_opt_state(params: Pytree, abstract: bool = False,
                   compress_grads: bool = False,
                   moment_dtype: str = "float32") -> Pytree:
    st = adamw_init(params, abstract=abstract, moment_dtype=moment_dtype)
    if compress_grads:
        st["err"] = ef_init(params, abstract=abstract)
    return st


def batch_to(batch, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    accum_steps: int = 1, compress_grads: bool = False,
                    accum_dtype: str = "float32"):
    adt = getattr(torch, accum_dtype)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = model.loss_fn(live, batch)
            leaves = tree_leaves(live)
            # a leaf the loss does not reach gets zeros, as from jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        # on a device mesh: each gradient reduced to its parameter's layout
        it = iter(like_param(g, p) for g, p in zip(grads, leaves))
        return loss.detach(), tree_map(lambda _: next(it), live)

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        micro = {k: reshape(v, (accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]))
                 for k, v in batch.items()}
        dev = tree_leaves(params)[0].device
        acc_loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc_g = tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
        for i in range(accum_steps):
            loss, g = value_and_grad(params, {k: v[i] for k, v in micro.items()})
            acc_loss = acc_loss + loss
            tree_map(lambda a, x: a.add_(x.to(adt)), acc_g, g)
            del g
        inv = 1.0 / accum_steps
        return acc_loss * inv, tree_map(lambda g: g.float() * inv, acc_g)

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            if compress_grads:
                grads, new_err = ef_compress_grads(grads, opt_state["err"])
            new_params, new_opt, gnorm = adamw_update(
                opt_cfg, grads,
                {k: v for k, v in opt_state.items() if k != "err"},
                params=params)
        if compress_grads:
            new_opt["err"] = new_err
        metrics = {"loss": loss, "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model, max_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch, max_len)
        return logits, cache
    return prefill_step


def make_serve_step(model: Model, greedy: bool = True):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        # on a device mesh the last logits are gathered over the vocabulary
        # first (DTensor's argmax over a split dimension fails at batch 1)
        last = shard(logits[:, -1], "batch", None)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step
