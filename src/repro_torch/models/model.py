"""Model: the public composable API, as far as the port has come.

    model = Model(get_config("gemma2-2b"))             # device="cuda"
    params = model.init_params(torch.Generator(device).manual_seed(0))
    logits = model.forward_logits(params, batch)       # teacher-forced
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)

The twin of ``src/repro/models/model.py``: decoder-only language models
(``global`` / ``local`` attention blocks with a dense MLP or a
mixture-of-experts layer, Griffin ``rglru`` blocks, Mamba2 ``mamba2``
blocks), a vision prefix (paligemma) and an encoder-decoder with an audio
front end (seamless).  Batches are dicts:

    lm families:  {"tokens": (B,S) int, "labels": (B,S) int}
    vision:       + {"patch_embeds": (B, num_prefix_tokens, D)}
    audio:        {"frames": (B, S_enc, D), "tokens", "labels"}

The front ends are stubs, as in the reference: precomputed embeddings are
projected by ``frontend/proj``.  A vision prefix takes the first
``num_prefix_tokens`` positions, so decode positions are offset by it and
``max_len`` covers prefix, prompt and new tokens; an encoder-decoder's
``init_cache`` takes ``enc_len``.  A mixture-of-experts model routes its
tokens in groups of ``min(cfg.moe_group_size, B·S)``, which must divide B·S
(``ValueError``), prefill and decode tick alike.  Everything runs eagerly;
``loss_fn`` differentiates through the ``einsum`` and ``blocked`` paths (what
``launch/train.py`` trains on), while the CUDA kernels of ``attn_impl="cuda"``
have no backward and refuse to launch under grad: serve under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import shard
from . import transformer as tf
from .layers import (apply_rmsnorm, cross_entropy, dtype_of, embed_tokens,
                     init_embeddings, init_rmsnorm, lm_logits)
from .params import ParamStore, tree_leaves


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- params
    def _init(self, ps: ParamStore):
        cfg = self.cfg
        init_embeddings(ps, cfg)
        if cfg.frontend in ("vision", "audio"):
            ps.param("frontend/proj", (cfg.d_model, cfg.d_model),
                     ("fsdp", None), "fan_in")
        if cfg.is_encoder_decoder:
            tf.init_stack(ps, "encoder", cfg, encoder=True)
            init_rmsnorm(ps, "enc_norm", cfg.d_model, None)
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
        return self._abstract_store().params

    def _abstract_store(self) -> ParamStore:
        ps = ParamStore(None, dtype_of(self.cfg), abstract=True)
        self._init(ps)
        return ps

    def param_pspecs(self):
        """The :class:`~repro_torch.sharding.P` tree under the installed
        rules (``sharding.use_mesh``), under the parameters' paths."""
        return self._abstract_store().specs

    def param_logical(self):
        """Each parameter's logical axes, under its path."""
        return self._abstract_store().logical

    def param_count(self) -> int:
        return sum(leaf.numel() for leaf in tree_leaves(self.abstract_params()))

    # ------------------------------------------------------------- helpers
    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device)[None, :]

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        """Token embeddings; a vision model's projected patch embeddings
        (cast to the model dtype) are prepended."""
        cfg = self.cfg
        x = embed_tokens(params, cfg, batch["tokens"])
        if cfg.frontend == "vision":
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe @ params["frontend"]["proj"].to(x.dtype), x],
                          dim=1)
        return shard(x, "batch", None, None)

    def _encode(self, params, batch) -> Optional[torch.Tensor]:
        """The encoder's output over ``batch["frames"]`` (None for a
        decoder-only model): frames cast to the model dtype, projected, the
        encoder stack at positions 0..S_enc-1, then ``enc_norm``."""
        cfg = self.cfg
        if not cfg.is_encoder_decoder:
            return None
        dt = dtype_of(cfg)
        enc_in = batch["frames"].to(dt) @ params["frontend"]["proj"].to(dt)
        h = tf.apply_stack(params["encoder"], cfg, enc_in,
                           self._positions(enc_in), encoder=True)
        return apply_rmsnorm(params["enc_norm"], h, cfg.norm_eps)

    # ------------------------------------------------------------- train
    def forward_logits(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        enc_out = self._encode(params, batch)
        x = self._embed_inputs(params, batch)
        x = tf.apply_stack(params["decoder"], cfg, x, self._positions(x),
                           enc_out=enc_out)
        x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if cfg.frontend == "vision":          # logits over text positions only
            x = x[:, cfg.num_prefix_tokens:, :]
        return lm_logits(params, cfg, x)

    def loss_fn(self, params, batch) -> torch.Tensor:
        logits = self.forward_logits(params, batch)
        return cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, device=None,
                   enc_len: int = 0):
        """An empty decode cache; ``enc_len``: the encoder positions an
        encoder-decoder model's cross K/V hold."""
        dev = self.device if device is None else resolve_device(device)
        return tf.init_stack_cache(self.cfg, batch, max_len, dev, enc_len)

    def prefill(self, params, batch, max_len: int):
        """Returns (last-position logits, cache ready for decode)."""
        cfg = self.cfg
        enc_out = self._encode(params, batch)
        x = self._embed_inputs(params, batch)
        x, cache = tf.prefill_stack(params["decoder"], cfg, x,
                                    self._positions(x), max_len,
                                    enc_out=enc_out)
        x = apply_rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return lm_logits(params, cfg, x), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos):
        """tokens: (B,1) int; pos: position of the new token, an int or a
        per-slot (B,) tensor (a vision model's counts its prefix).  ``cache``
        (K/V rows and recurrent states) is updated in place and returned."""
        cfg = self.cfg
        x = embed_tokens(params, cfg, tokens)
        x, cache = tf.decode_stack(params["decoder"], cfg, x, cache, pos)
        x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params, cfg, x), cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
