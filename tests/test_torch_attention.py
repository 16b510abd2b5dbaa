"""Port attention module against the JAX package's: self-attention on both
paths, the prefill->cache layout, one-token decode on full and ring caches.

float32, 1e-5 (summation order is the only difference).  On the CPU the port's
``attn_impl="cuda"`` runs the kernels' plain versions; the JAX ``pallas`` path
runs its kernels in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close, assert_trees_close, config_pair, rnd,
                         to_jax, to_torch)
from repro.models import attention as ja
from repro_torch.models import attention as ta

torch.set_num_threads(1)

TOL = 1e-5
IMPLS = [("einsum", "einsum"), ("pallas", "cuda"), ("einsum", "cuda")]


def attn_params(cfg, seed=0):
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = D ** -0.5
    return {"wq": rnd(seed, (D, H * Dh), s), "wk": rnd(seed + 1, (D, KV * Dh), s),
            "wv": rnd(seed + 2, (D, KV * Dh), s),
            "wo": rnd(seed + 3, (H * Dh, D), (H * Dh) ** -0.5)}


def both(tree):
    return ({k: to_jax(v) for k, v in tree.items()},
            {k: to_torch(v) for k, v in tree.items()})


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS)
@pytest.mark.parametrize("window", [None, 32], ids=["global", "local"])
def test_self_attention(jax_impl, torch_impl, window):
    jcfg, tcfg = config_pair("gemma2-2b", jax_impl, torch_impl)
    assert jcfg.attn_softcap == 50.0
    B, S = 2, 64
    jp, tp = both(attn_params(jcfg))
    x = rnd(9, (B, S, jcfg.d_model))
    pos = np.arange(S)[None, :]
    y, (k, v) = ta.self_attention(tp, tcfg, to_torch(x), torch.from_numpy(pos),
                                  window, return_kv=True)
    jy, (jk, jv) = ja.self_attention(jp, jcfg, to_jax(x), jnp.asarray(pos),
                                     window, return_kv=True)
    assert_close(y, jy, TOL)
    assert_close(k, jk, TOL)
    assert_close(v, jv, TOL)


def test_causal_mask():
    for window in (None, 5):
        got = ta.make_causal_mask(7, 12, 3, window)
        want = ja.make_causal_mask(7, 12, 3, window)
        assert got.shape == (1, 1, 7, 12)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,max_len,window", [
    (10, 48, 32),       # S < W: ring partly filled
    (45, 64, 32),       # S > W: the last W positions wrap around
    (20, 64, None),     # full cache, padded to max_len
    (24, 24, None),     # S == max_len: K/V returned unpadded
], ids=["ring_short", "ring_wrap", "full_pad", "full_brim"])
def test_build_cache_from_prefill(S, max_len, window):
    jcfg, tcfg = config_pair("gemma2-2b")
    shape = (2, S, jcfg.num_kv_heads, jcfg.head_dim)
    k, v = rnd(0, shape), rnd(1, shape)
    got = ta.build_cache_from_prefill(tcfg, to_torch(k), to_torch(v), max_len,
                                      window)
    want = ja.build_cache_from_prefill(jcfg, to_jax(k), to_jax(v), max_len,
                                       window)
    assert_trees_close(got, dict(want), 0.0)


def test_init_cache_shapes():
    _, tcfg = config_pair("gemma2-2b")
    full = ta.init_cache(tcfg, 3, 64, None, device="cpu")
    ring = ta.init_cache(tcfg, 3, 64, 32, device="cpu")
    assert full["k"].shape == (3, 64, tcfg.num_kv_heads, tcfg.head_dim)
    assert ring["v"].shape == (3, 32, tcfg.num_kv_heads, tcfg.head_dim)
    assert full["k"].dtype == torch.float32 and not full["k"].any()


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS[:2])
@pytest.mark.parametrize("window,L", [(None, 48), (32, 32)],
                         ids=["full", "ring"])
@pytest.mark.parametrize("pos", [7, [3, 40, 0]], ids=["scalar", "per_slot"])
def test_decode_self_attention(jax_impl, torch_impl, window, L, pos):
    """A few consecutive decode steps from a random cache; outputs and caches
    compared leaf by leaf.  The per-slot positions include one beyond the ring
    (40 > 32: the slot wraps) and an idle slot at 0."""
    jcfg, tcfg = config_pair("gemma2-2b", jax_impl, torch_impl)
    B = 3
    jp, tp = both(attn_params(jcfg))
    shape = (B, L, jcfg.num_kv_heads, jcfg.head_dim)
    cache = {"k": rnd(4, shape), "v": rnd(5, shape)}
    jc, tc = both(cache)
    pos = np.asarray(pos)
    for step in range(3):
        x = rnd(10 + step, (B, 1, jcfg.d_model))
        p_now = pos + step
        tpos = int(p_now) if p_now.ndim == 0 else torch.from_numpy(p_now)
        y, tc = ta.decode_self_attention(tp, tcfg, to_torch(x), tc, tpos, window)
        jy, jc = ja.decode_self_attention(jp, jcfg, to_jax(x), jc,
                                          jnp.asarray(p_now, jnp.int32), window)
        assert_close(y, jy, TOL)
        assert_trees_close(tc, dict(jc), TOL)


def test_decode_plan_shared_across_layers_changes_nothing():
    """``decode_stack`` makes one DecodePlan per tick and hands it to every
    layer; a layer given the plan computes what it computes without one."""
    _, tcfg = config_pair("gemma2-2b", torch_impl="cuda")
    _, tp = both(attn_params(tcfg))
    x = to_torch(rnd(0, (3, 1, tcfg.d_model)))
    pos = torch.tensor([3, 40, 0])
    plan = ta.DecodePlan(tcfg, pos, 3, x.device)
    for window, L in ((None, 48), (32, 32), (None, 48)):   # a key is reused
        shape = (3, L, tcfg.num_kv_heads, tcfg.head_dim)
        c1 = {"k": to_torch(rnd(1, shape)), "v": to_torch(rnd(2, shape))}
        c2 = {k: v.clone() for k, v in c1.items()}
        y1, c1 = ta.decode_self_attention(tp, tcfg, x, c1, pos, window)
        y2, c2 = ta.decode_self_attention(tp, tcfg, x, c2, pos, window, plan)
        assert torch.equal(y1, y2)
        assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])
    assert sorted(plan._by_cache, key=str) == [(32, 32), (None, 48)]


def test_decode_writes_the_cache_in_place():
    _, tcfg = config_pair("gemma2-2b")
    _, tp = both(attn_params(tcfg))
    cache = ta.init_cache(tcfg, 2, 16, None, device="cpu")
    x = to_torch(rnd(0, (2, 1, tcfg.d_model)))
    _, new = ta.decode_self_attention(tp, tcfg, x, cache,
                                      torch.tensor([2, 5]), None)
    assert new["k"] is cache["k"] and new["v"] is cache["v"]
    written = cache["k"].abs().sum(dim=(2, 3)) > 0
    assert written.tolist() == [[i == 2 for i in range(16)],
                                [i == 5 for i in range(16)]]


@pytest.mark.parametrize("kw,what", [
    (dict(attn_impl="blocked"), "attn_impl"),
    (dict(attn_impl="blocked_unroll"), "attn_impl"),
    (dict(attn_impl="pallas"), "attn_impl"),
    (dict(kv_cache_dtype="int8"), "int8"),
])
def test_unported_attention_options_raise(kw, what):
    _, tcfg = config_pair("gemma2-2b")
    tcfg = tcfg.replace(**kw)
    _, tp = both(attn_params(tcfg))
    x = to_torch(rnd(0, (1, 4, tcfg.d_model)))
    with pytest.raises(NotImplementedError, match=what):
        ta.self_attention(tp, tcfg, x, torch.arange(4)[None], None)
    with pytest.raises(NotImplementedError, match=what):
        ta.init_cache(tcfg, 1, 8, None, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.cross_attention(tp, tcfg, x, None)
