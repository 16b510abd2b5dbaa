"""The port's vision-prefix (paligemma-3b) and encoder-decoder
(seamless-m4t-large-v2) models against the JAX package's, from weights carried
across by ``from_jax_params``: parameters leaf for leaf, teacher-forced
logits, prefill and 6 decode steps (the vision prefix offsets the decode
positions) with the caches leaf by leaf, the cross K/V included.

float32, 1e-4 on logits and caches, as tests/test_torch_model.py (a few dozen
matrix products deep, each summed in another order by the two CPU back
ends).  The ``cuda`` path runs the kernels' plain versions on the CPU, the
JAX ``pallas`` path its kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close, assert_trees_close, config_pair,
                         numpy_tree, rnd)
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.params import tree_leaves

torch.set_num_threads(1)

TOL = 1e-4
B, S, N_PRE, S_ENC = 2, 40, 34, 24
ARCHS = ["paligemma-3b", "seamless-m4t-large-v2"]


def make_batch(cfg, seed, n_tokens=S):
    """numpy inputs: tokens, and the front end's precomputed embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_tokens))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rnd(seed + 1, (B, cfg.num_prefix_tokens,
                                               cfg.d_model))
    elif cfg.frontend == "audio":
        batch["frames"] = rnd(seed + 1, (B, S_ENC, cfg.d_model))
    return batch


def to_jax_batch(batch, n=None):
    return {k: jnp.asarray(v[:, :n] if k == "tokens" else v)
            for k, v in batch.items()}


def to_torch_batch(batch, n=None):
    return {k: torch.from_numpy(v[:, :n] if k == "tokens" else v)
            for k, v in batch.items()}


def offset(cfg) -> int:
    return cfg.num_prefix_tokens if cfg.frontend == "vision" else 0


@pytest.fixture(scope="module", params=[
    (arch, ji, ti) for arch in ARCHS
    for ji, ti in (("einsum", "einsum"), ("pallas", "cuda"))],
    ids=lambda p: "-".join(p))
def pair(request):
    arch, jax_impl, torch_impl = request.param
    jcfg, tcfg = config_pair(arch, jax_impl, torch_impl)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams, make_batch(jcfg, 3)


def test_params_carry_across_leaf_for_leaf(pair):
    """The new leaves (frontend/proj, encoder/..., enc_norm, .../xattn,
    .../normx) carry across like the rest."""
    jmodel, jparams, tmodel, tparams, _ = pair
    assert "frontend" in tparams
    if tmodel.cfg.is_encoder_decoder:
        assert {"encoder", "enc_norm"} <= set(tparams)
        assert {"xattn", "normx"} <= set(tparams["decoder"]["stack"]["p0"])
    assert_trees_close(tparams, numpy_tree(jparams), 0.0)
    assert_trees_close(tmodel.init_params(torch.Generator().manual_seed(0)),
                       numpy_tree(jax.tree.map(jnp.zeros_like, jparams)), 1e9)
    assert tmodel.param_count() == jmodel.param_count()
    assert tmodel.param_count() == sum(t.numel() for t in tree_leaves(tparams))


def test_forward_logits_match_jax(pair):
    """Vision: the prefix is stripped before the head."""
    jmodel, jparams, tmodel, tparams, batch = pair
    with torch.no_grad():
        out = tmodel.forward_logits(tparams, to_torch_batch(batch))
    want = jmodel.forward_logits(jparams, to_jax_batch(batch))
    assert out.shape == (B, S, tmodel.cfg.padded_vocab)
    assert_close(out, want, TOL)


def test_loss_matches_jax(pair):
    jmodel, jparams, tmodel, tparams, batch = pair
    labels = np.roll(batch["tokens"], -1, axis=1)
    with torch.no_grad():
        loss = tmodel.loss_fn(tparams, dict(to_torch_batch(batch),
                                            labels=torch.from_numpy(labels)))
    want = jmodel.loss_fn(jparams, dict(to_jax_batch(batch),
                                        labels=jnp.asarray(labels)))
    assert np.isfinite(float(loss))
    assert_close(loss, want, TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill, then 6 decode steps at positions offset by the vision
    prefix: logits every step and the caches at the end, leaf by leaf (the
    cross K/V ``ck`` / ``cv`` too)."""
    jmodel, jparams, tmodel, tparams, batch = pair
    cfg = tmodel.cfg
    off = offset(cfg)
    max_len = off + S + 8
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams, to_torch_batch(batch, N_PRE), max_len)
    jl, jc = jmodel.prefill(jparams, to_jax_batch(batch, N_PRE), max_len)
    assert tl.shape == (B, 1, cfg.padded_vocab)
    assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)
    if cfg.is_encoder_decoder:
        assert tc["stack"]["p0"]["ck"].shape == (
            cfg.num_layers, B, S_ENC, cfg.num_kv_heads, cfg.head_dim)
    jdecode = jax.jit(jmodel.decode_step)
    tokens = batch["tokens"]
    for i in range(N_PRE, S):
        with torch.no_grad():
            tl, tc = tmodel.decode_step(tparams, tc,
                                        torch.from_numpy(tokens[:, i:i + 1]),
                                        i + off)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i + off))
        assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_prefill_then_decode_matches_forward(arch, impl):
    """Inside the port: logits from (prefill + decode steps at per-slot
    positions) equal the teacher-forced forward logits position by
    position."""
    cfg = reduced(get_config(arch)).replace(attn_impl=impl)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    batch = to_torch_batch(make_batch(cfg, 0))
    off = offset(cfg)
    with torch.no_grad():
        full = model.forward_logits(params, batch)
        assert bool(torch.isfinite(full).all())
        pre = dict(batch, tokens=batch["tokens"][:, :N_PRE])
        logits, cache = model.prefill(params, pre, off + S + 8)
        assert_close(logits[:, 0], full[:, N_PRE - 1], TOL)
        for i in range(N_PRE, S):
            logits, cache = model.decode_step(
                params, cache, batch["tokens"][:, i:i + 1],
                torch.full((B,), i + off))
            assert_close(logits[:, 0], full[:, i], TOL)


def test_decode_from_an_empty_cache_with_enc_len():
    """``init_cache(batch, max_len, device, enc_len=)`` (the engine passes
    the device third) gives the xdec layers cross K/V of ``enc_len``
    positions; filled from a prefill's, decode continues as from the
    prefill's own cache."""
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    batch = to_torch_batch(make_batch(cfg, 4))
    cache = model.init_cache(B, S + 8, "cpu", enc_len=S_ENC)
    p0 = cache["stack"]["p0"]
    assert p0["ck"].shape == (cfg.num_layers, B, S_ENC, cfg.num_kv_heads,
                              cfg.head_dim)
    assert p0["ck"].dtype == torch.float32 and not p0["cv"].any()
    assert model.init_cache(B, 8, "cpu")["stack"]["p0"]["cv"].shape[2] == 0
    with torch.no_grad():
        _, pc = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :N_PRE]),
                              S + 8)
        for buf, new in zip(tree_leaves(cache), tree_leaves(pc)):
            buf.copy_(new)
        tok = batch["tokens"][:, N_PRE:N_PRE + 1]
        a, _ = model.decode_step(params, cache, tok, N_PRE)
        b, _ = model.decode_step(params, pc, tok, N_PRE)
    assert torch.equal(a, b)


def test_cross_attention_ignores_the_softcap():
    """Cross-attention takes no mask and no softcap whatever the config says
    (the reference's), and agrees with the JAX package's at 1e-5."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    jcfg, tcfg = config_pair("seamless-m4t-large-v2", attn_softcap=1.0)
    D, H, KV, Dh = jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    w = {"wq": rnd(0, (D, H * Dh), D ** -0.5), "wk": rnd(1, (D, KV * Dh), D ** -0.5),
         "wv": rnd(2, (D, KV * Dh), D ** -0.5),
         "wo": rnd(3, (H * Dh, D), (H * Dh) ** -0.5)}
    x, enc = rnd(4, (B, 5, D)), rnd(5, (B, 9, D), 4.0)
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    kv = ta.encode_cross_kv(tp, tcfg, torch.from_numpy(enc))
    y = ta.cross_attention(tp, tcfg, torch.from_numpy(x), kv)
    jkv = ja.encode_cross_kv(jp, jcfg, jnp.asarray(enc))
    assert_close(kv[0], jkv[0], 1e-5)
    assert_close(y, ja.cross_attention(jp, jcfg, jnp.asarray(x), jkv), 1e-5)
    uncapped = ta.cross_attention(tp, tcfg.replace(attn_softcap=None),
                                  torch.from_numpy(x), kv)
    assert torch.equal(y, uncapped)


def test_full_width_parameter_counts_equal_the_reference():
    for arch in ARCHS:
        want = jax_build_model(jax_get_config(arch)).param_count()
        assert build_model(get_config(arch), device="cpu").param_count() == want
