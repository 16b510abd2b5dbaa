"""The port's Model against the JAX package's, from weights carried across by
``from_jax_params``: teacher-forced logits, prefill, and prefill followed by
decode steps.  float32, 1e-4 on logits (a few dozen matrix products deep, each
summed in another order by the two CPU back ends).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close, assert_trees_close, config_pair,
                         numpy_tree)
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHITECTURES, get_config, reduced
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.params import tree_leaves

torch.set_num_threads(1)

TOL = 1e-4
B, S, N_PRE = 2, 40, 34              # S > window 32: the ring buffers wrap
MOE = ["deepseek-moe-16b", "dbrx-132b"]
PORTED = ["gemma2-2b", "granite-3-8b", "mistral-nemo-12b", "starcoder2-7b",
          "mamba2-130m", "recurrentgemma-2b"] + MOE
# the vision-prefix and encoder-decoder families: tests/test_torch_encdec.py
FRONT_ENDS = ["paligemma-3b", "seamless-m4t-large-v2"]


@pytest.fixture(scope="module", params=[
    ("gemma2-2b", "einsum", "einsum"), ("gemma2-2b", "pallas", "cuda"),
    ("granite-3-8b", "einsum", "einsum"), ("granite-3-8b", "pallas", "cuda"),
    ("mamba2-130m", "einsum", "einsum"), ("mamba2-130m", "pallas", "cuda"),
    ("recurrentgemma-2b", "einsum", "einsum"),
    ("recurrentgemma-2b", "pallas", "cuda"),
    ("deepseek-moe-16b", "einsum", "einsum"),
    ("deepseek-moe-16b", "pallas", "cuda"),
    ("dbrx-132b", "einsum", "einsum"), ("dbrx-132b", "pallas", "cuda"),
], ids=lambda p: "-".join(p))
def pair(request):
    arch, jax_impl, torch_impl = request.param
    jcfg, tcfg = config_pair(arch, jax_impl, torch_impl, window_size=32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    return jmodel, jparams, tmodel, tparams, tokens


def test_params_carry_across_leaf_for_leaf(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    assert_trees_close(tparams, numpy_tree(jparams), 0.0)
    assert_trees_close(tmodel.init_params(torch.Generator().manual_seed(0)),
                       numpy_tree(jax.tree.map(jnp.zeros_like, jparams)), 1e9)
    assert tmodel.param_count() == jmodel.param_count()
    assert tmodel.param_count() == sum(t.numel() for t in tree_leaves(tparams))


def test_forward_logits_match_jax(pair):
    jmodel, jparams, tmodel, tparams, tokens = pair
    with torch.no_grad():
        out = tmodel.forward_logits(tparams, {"tokens": torch.from_numpy(tokens)})
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(tokens)})
    assert out.shape == (B, S, tmodel.cfg.padded_vocab)
    assert_close(out, want, TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill, then 6 decode steps: logits every step and the caches at the
    end, leaf by leaf."""
    jmodel, jparams, tmodel, tparams, tokens = pair
    max_len = S + 8
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams,
                                {"tokens": torch.from_numpy(tokens[:, :N_PRE])},
                                max_len)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :N_PRE])},
                            max_len)
    assert tl.shape == (B, 1, tmodel.cfg.padded_vocab)
    assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(N_PRE, S):
        with torch.no_grad():
            tl, tc = tmodel.decode_step(tparams, tc,
                                        torch.from_numpy(tokens[:, i:i + 1]), i)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_prefill_then_decode_matches_forward(arch, impl):
    """Inside the port: logits from (prefill + decode steps) equal the
    teacher-forced forward logits position by position.  The MoE archs run
    with a capacity factor of num_experts / top_k, which drops nothing: the
    forward routes its 40 tokens as one group, the prefill its 34 and each
    decode tick its 2, so at a capacity that drops pairs they would drop
    different ones (as the reference would)."""
    cfg = reduced(get_config(arch)).replace(attn_impl=impl)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full = model.forward_logits(params, {"tokens": tokens})
        assert bool(torch.isfinite(full).all())
        if cfg.padded_vocab != cfg.vocab_size:
            assert float(full[..., cfg.vocab_size:].max()) < -1e20
        logits, cache = model.prefill(params, {"tokens": tokens[:, :N_PRE]},
                                      S + 8)
        assert_close(logits[:, 0], full[:, N_PRE - 1], TOL)
        for i in range(N_PRE, S):
            logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                              torch.full((B,), i))
            assert_close(logits[:, 0], full[:, i], TOL)


@pytest.mark.parametrize("jax_impl,torch_impl", [("einsum", "einsum"),
                                                 ("pallas", "cuda")])
def test_int8_cache_prefill_and_decode_match_jax(jax_impl, torch_impl):
    """gemma2-2b with ``kv_cache_dtype="int8"`` (window 32: the ring caches
    wrap): prefill, then 6 decode steps; logits every step at 1e-4 and the
    caches leaf by leaf, the codes equal.  The quantisation itself is bit for
    bit (tests/test_torch_attention.py); what reaches it differs by a few ulp
    (matrix products summed in another order), which could move a code that
    sits on a rounding tie by one step of amax/127, about 1e-2 on a logit.
    At these seeds none moves, so the model's 1e-4 holds and is kept."""
    jcfg, tcfg = config_pair("gemma2-2b", jax_impl, torch_impl,
                             window_size=32, kv_cache_dtype="int8")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams,
                                {"tokens": torch.from_numpy(tokens[:, :N_PRE])},
                                S + 8)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :N_PRE])},
                            S + 8)
    assert tc["stack"]["p0"]["kv"]["k"].dtype == torch.int8
    assert tc["stack"]["p0"]["kv"]["k_scale"].dtype == torch.bfloat16
    assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(N_PRE, S):
        with torch.no_grad():
            tl, tc = tmodel.decode_step(tparams, tc,
                                        torch.from_numpy(tokens[:, i:i + 1]), i)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        assert_close(tl, jl, TOL)
    assert_trees_close(tc, numpy_tree(jc), TOL)


def test_cuda_path_matches_einsum_path():
    """cfg.attn_impl='cuda' reproduces the einsum forward (the twin of the
    reference's pallas-vs-einsum test, same 3e-2)."""
    cfg = reduced(get_config("gemma2-2b")).replace(window_size=64)
    model = build_model(cfg.replace(attn_impl="einsum"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)))
    with torch.no_grad():
        base = model.forward_logits(params, {"tokens": tokens})
        out = build_model(cfg.replace(attn_impl="cuda"), device="cpu") \
            .forward_logits(params, {"tokens": tokens})
    assert_close(out, base, 3e-2)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_kernel_paths_match_the_einsum_paths(arch):
    """The twin of tests/test_kernels.py:182 for the recurrent families: the
    port's forward with attn_impl 'cuda' and 'einsum' against the JAX
    package's with 'einsum' and 'pallas', all four within 3e-2 of each other
    (B=2, S=128, window 64, converted weights)."""
    jcfg, tcfg = config_pair(arch, window_size=64)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 128))
    base = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(tokens)})
    jk = jax_build_model(jcfg.replace(attn_impl="pallas")).forward_logits(
        jparams, {"tokens": jnp.asarray(tokens)})
    assert_close(jk, base, 3e-2)
    for impl in ("cuda", "einsum"):
        with torch.no_grad():
            out = build_model(tcfg.replace(attn_impl=impl), device="cpu") \
                .forward_logits(tparams, {"tokens": torch.from_numpy(tokens)})
        assert_close(out, base, 3e-2)
        assert_close(out, jk, 3e-2)


def test_loss_matches_jax(pair):
    jmodel, jparams, tmodel, tparams, tokens = pair
    labels = np.roll(tokens, -1, axis=1)
    with torch.no_grad():
        loss = tmodel.loss_fn(tparams, {"tokens": torch.from_numpy(tokens),
                                        "labels": torch.from_numpy(labels)})
    want = jmodel.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels)})
    assert np.isfinite(float(loss))
    assert_close(loss, want, TOL)


def test_bf16_params_carry_across_exactly():
    jcfg, tcfg = config_pair("gemma2-2b", dtype="bfloat16")
    jparams = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    assert tparams["embed"]["tok"].dtype == torch.bfloat16
    assert tparams["final_norm"]["scale"].dtype == torch.float32
    assert_trees_close(tparams, numpy_tree(jparams), 0.0)
    cast = from_jax_params(numpy_tree(jparams), device="cpu",
                           dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in tree_leaves(cast))
    assert_trees_close(cast, numpy_tree(jparams), 0.0)


def test_full_width_parameter_counts_equal_the_reference():
    from repro.configs import get_config as jax_get_config
    for arch in PORTED + FRONT_ENDS:
        want = jax_build_model(jax_get_config(arch)).param_count()
        assert build_model(get_config(arch), device="cpu").param_count() == want


def test_every_architecture_is_ported():
    assert set(PORTED) | set(FRONT_ENDS) == set(ARCHITECTURES)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(reduced(get_config("gemma2-2b")))
