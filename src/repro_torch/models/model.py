"""Model: the public composable API, as far as the port has come.

    model = Model(get_config("gemma2-2b"))             # device="cuda"
    params = model.init_params(torch.Generator(device).manual_seed(0))
    logits = model.forward_logits(params, batch)       # teacher-forced
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)

The twin of ``src/repro/models/model.py`` for decoder-only language models:
``global`` / ``local`` attention blocks with a dense MLP, Griffin ``rglru``
blocks (recurrentgemma) and Mamba2 ``mamba2`` blocks.  Batches are dicts:
``{"tokens": (B,S) int}``.  Vision/audio front ends and encoder-decoder
models raise ``NotImplementedError`` (ROADMAP.md queue 1).  Everything runs
eagerly and without autograd state: call under ``torch.no_grad()`` when
serving.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from . import transformer as tf
from .layers import (apply_rmsnorm, cross_entropy, dtype_of, embed_tokens,
                     init_embeddings, init_rmsnorm, lm_logits)
from .params import ParamStore, tree_leaves


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.frontend is not None or cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: vision/audio front ends and encoder-decoder "
                "models are not ported yet (ROADMAP.md queue 1)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- params
    def _init(self, ps: ParamStore):
        cfg = self.cfg
        init_embeddings(ps, cfg)
        tf.init_stack(ps, "decoder", cfg)
        init_rmsnorm(ps, "final_norm", cfg.d_model, None)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None):
        """Random parameters on ``device`` (default: the model's), drawn from
        ``generator`` (default: a new one on that device, seed 0)."""
        dev = self.device if device is None else resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        ps = ParamStore(generator, dtype_of(self.cfg), dev)
        self._init(ps)
        return ps.params

    def abstract_params(self):
        """The parameter tree on the ``meta`` device: shapes, no storage."""
        ps = ParamStore(None, dtype_of(self.cfg), abstract=True)
        self._init(ps)
        return ps.params

    def param_count(self) -> int:
        return sum(leaf.numel() for leaf in tree_leaves(self.abstract_params()))

    # ------------------------------------------------------------- train
    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device)[None, :]

    def forward_logits(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        x = embed_tokens(params, cfg, batch["tokens"])
        x = tf.apply_stack(params["decoder"], cfg, x, self._positions(x))
        x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params, cfg, x)

    def loss_fn(self, params, batch) -> torch.Tensor:
        logits = self.forward_logits(params, batch)
        return cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, device=None):
        dev = self.device if device is None else resolve_device(device)
        return tf.init_stack_cache(self.cfg, batch, max_len, dev)

    def prefill(self, params, batch, max_len: int):
        """Returns (last-position logits, cache ready for decode)."""
        cfg = self.cfg
        x = embed_tokens(params, cfg, batch["tokens"])
        x, cache = tf.prefill_stack(params["decoder"], cfg, x,
                                    self._positions(x), max_len)
        x = apply_rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return lm_logits(params, cfg, x), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos):
        """tokens: (B,1) int; pos: position of the new token, an int or a
        per-slot (B,) tensor.  ``cache`` (K/V rows and recurrent states) is
        updated in place and returned."""
        cfg = self.cfg
        x = embed_tokens(params, cfg, tokens)
        x, cache = tf.decode_stack(params["decoder"], cfg, x, cache, pos)
        x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params, cfg, x), cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
