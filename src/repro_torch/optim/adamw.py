"""AdamW with f32 master weights.

The twin of ``src/repro/optim/adamw.py``.  Optimizer state = ``{"master",
"mu", "nu", "step"}``: an f32 master copy of every parameter, the two moments
in ``moment_dtype``, and ``step`` a 0-d int32 tensor — the reference's tree,
so a checkpoint of either package restores in the other.  ``adamw_update``
clips by the global norm, computes in f32 and emits new parameters in each
old leaf's dtype.

No ``torch.optim.AdamW``: its update has neither the f32 master nor the global
clip.  The reference's ``jit`` donates the state; here ``adamw_update``
updates ``master``, ``mu`` and ``nu`` IN PLACE, leaf by leaf, so the old and
new f32 trees never coexist.  Every product and sum of the update is its own
op, in the reference's order (no ``addcmul_``, ``lerp_`` or ``alpha=``, which
may round once where the reference rounds twice), and nothing divides by a
Python number (on a CUDA tensor that is a multiply by the rounded reciprocal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from ..models.params import tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moment storage dtype: "bfloat16" halves the optimizer state's memory
    # (the update math stays f32; master weights stay f32)
    moment_dtype: str = "float32"


def sorted_leaves(tree: Pytree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    return [tree]


def adamw_init(params: Pytree, abstract: bool = False,
               moment_dtype: str = "float32") -> Pytree:
    """``abstract=True``: tensors on the ``meta`` device (shapes, no storage)."""
    mdt = getattr(torch, moment_dtype)

    def f32_like(p):
        if abstract:
            return torch.empty(p.shape, dtype=torch.float32, device="meta")
        # a copy even when params are f32: the update writes master in place
        return p.detach().to(torch.float32, copy=True)

    def zeros_like_m(p):
        return torch.zeros(p.shape, dtype=mdt,
                           device="meta" if abstract else p.device)

    dev = "meta" if abstract else sorted_leaves(params)[0].device
    return {
        "master": tree_map(f32_like, params),
        "mu": tree_map(zeros_like_m, params),
        "nu": tree_map(zeros_like_m, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in sorted_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Pytree, opt_state: Pytree,
                 params: Optional[Pytree] = None,
                 lr=None) -> Tuple[Pytree, Pytree, torch.Tensor]:
    """Returns (new_params_in_param_dtype, new_opt_state, grad_norm).

    ``params`` is used only for its leaf dtypes (grads may be f32 after
    accumulation); defaults to grads' dtypes.  ``opt_state``'s ``master``,
    ``mu`` and ``nu`` are updated in place and returned in the new state
    (with a new ``step``); the new parameters are new tensors."""
    dev = opt_state["step"].device
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.grad_clip, dtype=torch.float32, device=dev)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr,
                           dtype=torch.float32).to(dev)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, m, v, w):
        g = g.float() * scale                      # a new tensor
        m2 = m.float()                             # m itself when f32
        # lint: waive DN001 -- m2 is m when f32, on purpose (else copied back)
        m2.mul_(cfg.b1)
        t = (1.0 - cfg.b1) * g
        m2.add_(t)                                 # b1·m + (1-b1)·g
        v2 = v.float()
        # lint: waive DN001 -- v2 is v when f32, on purpose (else copied back)
        v2.mul_(cfg.b2)
        g.square_()
        g.mul_(1.0 - cfg.b2)
        v2.add_(g)                                 # b2·v + (1-b2)·g²
        del g
        mhat = m2 / b1c
        vhat = v2 / b2c
        vhat.sqrt_()
        vhat.add_(cfg.eps)
        mhat.div_(vhat)                            # mhat / (sqrt(vhat) + eps)
        torch.mul(w, cfg.weight_decay, out=t)
        mhat.add_(t)
        mhat.mul_(lr_t)
        w.sub_(mhat)                               # w - lr·(... + wd·w)
        if m2 is not m:                            # moments stored in mdt
            m.copy_(m2)
        if v2 is not v:
            v.copy_(v2)

    tree_map(upd, grads, opt_state["mu"], opt_state["nu"],
             opt_state["master"])
    dtype_src = params if params is not None else grads
    new_params = tree_map(lambda w, p_old: w.to(p_old.dtype, copy=True),
                          opt_state["master"], dtype_src)
    new_opt = {"master": opt_state["master"], "mu": opt_state["mu"],
               "nu": opt_state["nu"], "step": step}
    return new_params, new_opt, gnorm


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
