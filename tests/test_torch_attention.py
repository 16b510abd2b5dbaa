"""Port attention module against the JAX package's: self-attention on every
path (the blocked forms included), the prefill->cache layout, one-token decode
on full and ring caches, the int8 KV cache.

float32, 1e-5 (summation order is the only difference); int8 quantisation
bit for bit on identical inputs; bf16 2e-2.  On the CPU the port's
``attn_impl="cuda"`` runs the kernels' plain versions; the JAX ``pallas`` path
runs its kernels in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (JDT, TDT, assert_close, assert_trees_close,
                         config_pair, rnd, to_jax, to_torch)
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
    (dict(attn_impl="pallas"), "attn_impl"),
])
def test_unported_attention_options_raise(kw, what):
    """The reference's name for its kernels is refused: the port's is
    'cuda'."""
    _, tcfg = config_pair("gemma2-2b")
    tcfg = tcfg.replace(**kw)
    _, tp = both(attn_params(tcfg))
    x = to_torch(rnd(0, (1, 4, tcfg.d_model)))
    with pytest.raises(NotImplementedError, match=what):
        ta.self_attention(tp, tcfg, x, torch.arange(4)[None], None)
    with pytest.raises(NotImplementedError, match=what):
        ta.init_cache(tcfg, 1, 8, None, device="cpu")


# ---------------------------------------------------------------- int8 cache

def _kv_rows(dtype):
    """(5, 3, 16) K/V rows: random ones, rows whose codes fall on exact .5
    ties (amax 127 -> scale 1, amax 254 -> scale 2), an all-zero row and a
    row of one tiny value."""
    x = rnd(0, (5, 3, 16), 2.0)
    ties = np.array([2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 4.0] * 2,
                    np.float32)
    ties[0] = 127.0
    x[1, 0] = ties
    x[1, 1] = ties * 2
    x[1, 2] = 0.0
    x[2, 0] = 0.0
    x[2, 0, 3] = 3e-7
    return x if dtype == "float32" else np.asarray(to_torch(x, dtype).float())


def _bits(t):
    """A torch or jax array as raw integers (bf16 as its 16 bits)."""
    a = np.asarray(t.view(torch.int16) if isinstance(t, torch.Tensor)
                   and t.dtype == torch.bfloat16 else t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_kv_bit_for_bit(dtype):
    """Codes, scales and dequantised values equal the JAX package's bit for
    bit: round half to even on the ties, scale 1e-6/127 (in bf16) on a zero
    row."""
    x = _kv_rows(dtype)
    q, scale = ta.quantize_kv(to_torch(x, dtype))
    jq, jscale = ja.quantize_kv(to_jax(x, dtype))
    assert q.dtype == torch.int8 and scale.dtype == torch.bfloat16
    assert scale.shape == (5, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))
    assert q[1, 0, :8].tolist() == [127, -4, 0, 0, 2, 126, -126, 4]
    assert not q[1, 2].any()
    assert float(scale[1, 2, 0]) == float(torch.tensor(1e-6 / 127).bfloat16())
    for dt in ("float32", "bfloat16"):
        got = ta.dequantize_kv(q, scale, TDT[dt])
        want = ja.dequantize_kv(jq, jscale, JDT[dt])
        assert got.dtype == TDT[dt]
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_init_cache_int8():
    jcfg, tcfg = config_pair("gemma2-2b", kv_cache_dtype="int8")
    for window in (None, 32):
        got = ta.init_cache(tcfg, 3, 64, window, device="cpu")
        want = ja.init_cache(jcfg, 3, 64, window)
        assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
        for name in got:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
            assert not got[name].any()


@pytest.mark.parametrize("S,max_len,window", [
    (10, 48, 32), (45, 64, 32), (20, 64, None), (24, 24, None)],
    ids=["ring_short", "ring_wrap", "full_pad", "full_brim"])
def test_build_cache_from_prefill_int8(S, max_len, window):
    """The whole arranged cache quantised, padding rows included: bit for
    bit."""
    jcfg, tcfg = config_pair("gemma2-2b", kv_cache_dtype="int8")
    shape = (2, S, jcfg.num_kv_heads, jcfg.head_dim)
    k, v = rnd(0, shape), rnd(1, shape)
    got = ta.build_cache_from_prefill(tcfg, to_torch(k), to_torch(v), max_len,
                                      window)
    want = ja.build_cache_from_prefill(jcfg, to_jax(k), to_jax(v), max_len,
                                       window)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS[:2])
@pytest.mark.parametrize("window,L", [(None, 48), (32, 32)],
                         ids=["full", "ring"])
def test_decode_self_attention_int8(jax_impl, torch_impl, window, L):
    """Three decode steps from the same int8 cache and x (per-slot positions,
    one beyond the ring): outputs at 1e-5, the cache's codes and scales
    written in place and equal to the JAX package's (1e-5 on codes holds
    them equal: no product here lands within 1e-5 of a rounding tie)."""
    jcfg, tcfg = config_pair("gemma2-2b", jax_impl, torch_impl,
                             kv_cache_dtype="int8")
    B = 3
    jp, tp = both(attn_params(jcfg))
    shape = (B, L, jcfg.num_kv_heads, jcfg.head_dim)
    kq, ks = ja.quantize_kv(to_jax(rnd(4, shape)))
    vq, vs = ja.quantize_kv(to_jax(rnd(5, shape)))
    jc = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    tc = {name: torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(torch.bfloat16 if "scale" in name else torch.int8)
          for name, a in jc.items()}
    before = dict(tc)
    pos = np.asarray([3, 40, 0])
    for step in range(3):
        x = rnd(10 + step, (B, 1, jcfg.d_model))
        y, tc = ta.decode_self_attention(tp, tcfg, to_torch(x), tc,
                                         torch.from_numpy(pos + step), window)
        jy, jc = ja.decode_self_attention(jp, jcfg, to_jax(x), jc,
                                          jnp.asarray(pos + step, jnp.int32),
                                          window)
        assert_close(y, jy, TOL)
        assert_trees_close(tc, dict(jc), TOL)
    assert all(tc[name] is before[name] for name in tc)


# ---------------------------------------------------------------- blocked

@pytest.mark.parametrize("impl", ["blocked", "blocked_unroll"])
@pytest.mark.parametrize("window", [None, 32], ids=["global", "local"])
@pytest.mark.parametrize("scores_f32", [True, False], ids=["f32", "lowp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_blocked(impl, window, scores_f32, dtype):
    """The blocked forms against the JAX package's on one device (its
    context-parallel form falls back to _attend_blocked there): 1e-5 in f32
    (``attn_scores_f32=False`` then changes nothing), bf16's 2e-2 in bf16,
    where the scores are bf16 when ``attn_scores_f32`` is False."""
    jcfg, tcfg = config_pair("gemma2-2b", impl, impl, dtype=dtype,
                             attn_scores_f32=scores_f32)
    B, S = 2, 64
    jp, tp = both(attn_params(jcfg))
    x = rnd(9, (B, S, jcfg.d_model))
    pos = np.arange(S)[None, :]
    y = ta.self_attention(tp, tcfg, to_torch(x, dtype), torch.from_numpy(pos),
                          window)
    jy = ja.self_attention(jp, jcfg, to_jax(x, dtype), jnp.asarray(pos), window)
    assert y.dtype == TDT[dtype]
    assert_close(y, jy, TOL if dtype == "float32" else 2e-2)
    if dtype == "float32":                 # the same function as einsum
        _, ecfg = config_pair("gemma2-2b", dtype=dtype)
        assert_close(y, ta.self_attention(tp, ecfg, to_torch(x),
                                          torch.from_numpy(pos), window), TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)],
                         ids=["causal", "window", "bidirectional"])
@pytest.mark.parametrize("scores_f32", [True, False], ids=["f32", "lowp"])
def test_attend_blocked_chunks(causal, window, scores_f32):
    """_attend_blocked called directly with chunk=32 over S=320: ten chunks,
    and with the window of 100 the key range of the chunks from row 256 on
    starts at k_lo = 128 > 0.  GQA (4 heads on 2), softcap 50; f32 at 1e-5,
    and bf16 (2e-2) where the scores are bf16 when ``scores_f32`` is
    False."""
    B, S, H, KV, Dh = 2, 320, 4, 2, 16
    q, k, v = rnd(1, (B, S, H, Dh)), rnd(2, (B, S, KV, Dh)), rnd(3, (B, S, KV, Dh))
    kw = dict(causal=causal, window=window, softcap=50.0, scale=Dh ** -0.5,
              chunk=32, scores_f32=scores_f32)
    for dtype, tol in (("float32", TOL), ("bfloat16", 2e-2)):
        got = ta._attend_blocked(to_torch(q, dtype), to_torch(k, dtype),
                                 to_torch(v, dtype), **kw)
        want = ja._attend_blocked(to_jax(q, dtype), to_jax(k, dtype),
                                  to_jax(v, dtype), **kw)
        assert_close(got, want, tol)
    mask = ta.make_causal_mask(S, S, 0, window) if causal else None
    assert_close(got.float(), ta._attend_einsum(
        to_torch(q), to_torch(k), to_torch(v), mask, 50.0, Dh ** -0.5), 2e-2)


def test_decode_under_the_blocked_names_runs_einsum():
    """Decode with either blocked name is the einsum path's, bit for bit (the
    reference's decode tests only for 'pallas')."""
    _, ecfg = config_pair("gemma2-2b")
    _, tp = both(attn_params(ecfg))
    shape = (2, 48, ecfg.num_kv_heads, ecfg.head_dim)
    x = to_torch(rnd(0, (2, 1, ecfg.d_model)))
    outs = []
    for impl in ("einsum", "blocked", "blocked_unroll"):
        cache = {"k": to_torch(rnd(1, shape)), "v": to_torch(rnd(2, shape))}
        outs.append(ta.decode_self_attention(
            tp, ecfg.replace(attn_impl=impl), x, cache, torch.tensor([5, 30]),
            None)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
