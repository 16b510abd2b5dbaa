"""Port layers against the JAX package's, same numpy inputs, float32, 1e-5
(sums are taken in another order by the two CPU back ends; nothing else
differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close, config_pair, rnd, to_jax, to_torch
from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = 1e-5


def both(x):
    return to_jax(x), to_torch(x)


def test_rmsnorm():
    x = rnd(0, (2, 7, 64), scale=3.0)
    scale = 1.0 + rnd(1, (64,), scale=0.1)
    jx, tx = both(x)
    js, ts = both(scale)
    assert_close(tl.apply_rmsnorm({"scale": ts}, tx, 1e-6),
                 jl.apply_rmsnorm({"scale": js}, jx, 1e-6), TOL)


def test_rmsnorm_keeps_the_input_dtype_with_an_f32_scale():
    x = to_torch(rnd(0, (2, 3, 64)), "bfloat16")
    y = tl.apply_rmsnorm({"scale": torch.ones(64)}, x)
    assert y.dtype == torch.bfloat16
    jy = jl.apply_rmsnorm({"scale": jnp.ones(64)},
                          to_jax(rnd(0, (2, 3, 64)), "bfloat16"))
    assert_close(y, jy, 1e-2)


@pytest.mark.parametrize("positions", [
    np.arange(9)[None, :],                       # (1,S): prefill
    np.array([[3], [0], [41]]),                  # (B,1): per-slot decode
], ids=["row", "per_slot"])
def test_rope(positions):
    B = 3
    S = positions.shape[1]
    x = rnd(0, (B, S, 4, 16))
    jx, tx = both(x)
    out = tl.apply_rope(tx, torch.from_numpy(positions), 10_000.0)
    want = jl.apply_rope(jx, jnp.asarray(positions), 10_000.0)
    assert_close(out, want, TOL)


def test_rope_with_precomputed_tables_is_the_same():
    x = to_torch(rnd(0, (3, 5, 4, 16)))
    pos = torch.arange(5)[None, :]
    tables = tl.rope_tables(pos, 16, 10_000.0)
    assert tables[0].shape == (1, 5, 1, 8) and tables[0].dtype == torch.float32
    assert torch.equal(tl.apply_rope(x, pos, 10_000.0, tables),
                       tl.apply_rope(x, pos, 10_000.0))


def test_rope_is_half_split_not_interleaved():
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[..., 0] = 1.0
    out = tl.apply_rope(to_torch(x), torch.tensor([[1]]), 10_000.0)[0, 0, 0]
    # dim 0 pairs with dim 4 (= half), not with dim 1
    assert abs(float(out[4]) - np.sin(1.0)) < 1e-6 and float(out[1]) == 0.0


@pytest.mark.parametrize("arch,act,gated", [("gemma2-2b", "gelu", False),
                                            ("granite-3-8b", "silu", True)])
def test_mlp(arch, act, gated):
    jcfg, tcfg = config_pair(arch)
    assert jcfg.act == act
    D, Fd = jcfg.d_model, jcfg.d_ff
    p = {"w_in": rnd(1, (D, Fd), 0.2), "w_out": rnd(2, (Fd, D), 0.2)}
    if gated:
        p["w_gate"] = rnd(3, (D, Fd), 0.2)
    x = rnd(0, (2, 5, D), scale=2.0)      # wide enough to tell tanh-gelu from erf
    out = tl.apply_mlp({k: to_torch(v) for k, v in p.items()}, tcfg, to_torch(x))
    want = jl.apply_mlp({k: to_jax(v) for k, v in p.items()}, jcfg, to_jax(x))
    assert_close(out, want, TOL)


def test_mlp_init_is_gated_only_for_silu():
    from repro_torch.models.params import ParamStore
    for arch, keys in (("gemma2-2b", {"w_in", "w_out"}),
                       ("granite-3-8b", {"w_gate", "w_in", "w_out"})):
        _, tcfg = config_pair(arch)
        ps = ParamStore(None, torch.float32, abstract=True)
        tl.init_mlp(ps, "mlp", tcfg, tcfg.d_ff, stacked=3)
        assert set(ps.params["mlp"]) == keys
        assert ps.params["mlp"]["w_in"].shape == (3, tcfg.d_model, tcfg.d_ff)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens(dtype):
    jcfg, tcfg = config_pair("gemma2-2b", dtype=dtype)
    emb = rnd(0, (jcfg.padded_vocab, jcfg.d_model), 0.1)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 6))
    out = tl.embed_tokens({"embed": {"tok": to_torch(emb, dtype)}}, tcfg,
                          torch.from_numpy(toks))
    want = jl.embed_tokens({"embed": {"tok": to_jax(emb, dtype)}}, jcfg,
                           jnp.asarray(toks))
    assert out.dtype == to_torch(emb, dtype).dtype
    # bf16: both round the sqrt(d_model) multiplier and the product the same way
    assert_close(out, want, TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("vocab_size", [256, 250], ids=["exact", "padded"])
@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_softcap_and_padded_vocab(vocab_size, tied):
    jcfg, tcfg = config_pair("gemma2-2b", vocab_size=vocab_size,
                             tie_embeddings=tied)
    assert jcfg.final_softcap == 30.0 and jcfg.padded_vocab == 256
    D, V = jcfg.d_model, jcfg.padded_vocab
    p = {"embed": {"tok": rnd(0, (V, D), 0.5), "head": rnd(1, (D, V), 0.5)}}
    x = rnd(2, (2, 3, D), scale=4.0)          # large enough to bend the tanh
    tp = {"embed": {k: to_torch(v) for k, v in p["embed"].items()}}
    jp = {"embed": {k: to_jax(v) for k, v in p["embed"].items()}}
    out = tl.lm_logits(tp, tcfg, to_torch(x))
    want = jl.lm_logits(jp, jcfg, to_jax(x))
    assert out.shape == (2, 3, V)
    assert_close(out, want, TOL)
    if vocab_size != V:
        assert float(out[..., vocab_size:].max()) < -1e20
    assert float(out[..., :vocab_size].abs().max()) <= 30.0


def test_cross_entropy():
    logits = rnd(0, (2, 5, 32), 2.0)
    labels = np.random.default_rng(1).integers(0, 32, (2, 5))
    mask = (np.random.default_rng(2).random((2, 5)) > 0.3).astype(np.float32)
    assert_close(tl.cross_entropy(to_torch(logits), torch.from_numpy(labels)),
                 jl.cross_entropy(to_jax(logits), jnp.asarray(labels)), TOL)
    assert_close(tl.cross_entropy(to_torch(logits), torch.from_numpy(labels),
                                  to_torch(mask)),
                 jl.cross_entropy(to_jax(logits), jnp.asarray(labels),
                                  to_jax(mask)), TOL)
