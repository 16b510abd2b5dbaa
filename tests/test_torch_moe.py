"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``: the same parameters (drawn by the JAX
package's ``init_moe``, carried across by ``from_jax_params``) and the same
numpy inputs.  f32 1e-5 (the products are summed in another order by the two
CPU back ends); bf16 2e-2 absolute plus relative.  The routing itself (top-k
indices, capacity slots, which pairs are dropped) must be equal, ties
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JDT, TDT, assert_close, config_pair, numpy_tree, rnd
from repro.models import moe as jmoe
from repro.models.params import ParamStore as JaxParamStore
from repro_torch.models import from_jax_params
from repro_torch.models import moe as tmoe
from repro_torch.models.params import ParamStore

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ["deepseek-moe-16b", "dbrx-132b"]      # with / without shared experts


def moe_pair(arch, dtype="float32", seed=0, **overrides):
    """(jax cfg, torch cfg, jax params, torch params) of one MoE layer."""
    jcfg, tcfg = config_pair(arch, dtype=dtype, **overrides)
    ps = JaxParamStore(jax.random.PRNGKey(seed), JDT[dtype])
    jmoe.init_moe(ps, "moe", jcfg, None)
    jp = ps.params["moe"]
    return jcfg, tcfg, jp, from_jax_params(numpy_tree(jp), device="cpu")


def inputs(seed, shape, dtype="float32"):
    x = rnd(seed, shape)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_declares_the_reference_tree(arch):
    """Paths, shapes and dtypes leaf for leaf (the router f32 in a bf16
    model), stacked and not."""
    for stacked in (None, 3):
        jcfg, tcfg = config_pair(arch, dtype="bfloat16")
        jps = JaxParamStore(None, jnp.bfloat16, abstract=True)
        jmoe.init_moe(jps, "moe", jcfg, stacked)
        tps = ParamStore(None, torch.bfloat16, abstract=True)
        tmoe.init_moe(tps, "moe", tcfg, stacked)

        def flat(tree, pre=""):
            if isinstance(tree, dict):
                return {k2: v for k, sub in tree.items()
                        for k2, v in flat(sub, f"{pre}/{k}").items()}
            return {pre: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
        assert flat(tps.params) == flat(jps.params)
        assert flat(tps.params)["/moe/router"][1] == "float32"
        assert ("/moe/shared/w_in" in flat(tps.params)) == \
            (arch == "deepseek-moe-16b")


@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_and_top_k_match_jax(arch):
    jcfg, tcfg, jp, tp = moe_pair(arch)
    jx, tx = inputs(1, (40, jcfg.d_model))
    jprobs, jtopi, jtopw = jmoe._router_probs(jp, jcfg, jx)
    probs, topi, topw = tmoe._router_probs(tp, tcfg, tx)
    assert_close(probs, jprobs, 1e-6)
    assert_close(topw, jtopw, 1e-6)
    assert np.array_equal(topi.numpy(), np.asarray(jtopi))
    assert probs.dtype == topw.dtype == torch.float32


@pytest.mark.parametrize("tied", ["zero_router", "equal_columns"])
def test_top_k_ties_take_the_lower_expert_first(tied):
    """A zero router ties every expert: the reference takes 0..k-1.  Equal
    router columns tie those experts only, in and out of the top k."""
    jcfg, tcfg, jp, tp = moe_pair("dbrx-132b", top_k=3)
    router = np.asarray(jp["router"]).copy()
    if tied == "zero_router":
        router[:] = 0.0
    else:
        router[:, [2, 5, 6]] = router[:, [4]]
        router[:, 7] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jx, tx = inputs(2, (40, jcfg.d_model))
    _, jtopi, jtopw = jmoe._router_probs(jp, jcfg, jx)
    _, topi, topw = tmoe._router_probs(tp, tcfg, tx)
    assert np.array_equal(topi.numpy(), np.asarray(jtopi))
    assert_close(topw, jtopw, 1e-6)
    if tied == "zero_router":
        assert (topi.numpy() == np.arange(3)).all()
    else:                 # some top-k holds two tied experts, in index order
        tie = (topw[:, :-1] == topw[:, 1:]).any(-1)
        assert bool(tie.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cf in (0.25, 1.0, 1.25, 2.0):
        jcfg, tcfg = config_pair(arch, capacity_factor=cf)
        full_j, full_t = jcfg.replace(num_layers=1), tcfg.replace(num_layers=1)
        for tokens in (1, 3, 4, 7, 8, 31, 40, 64, 80, 100, 257, 1000, 2048):
            assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)
            assert tmoe._capacity(tokens, full_t) == \
                jmoe._capacity(tokens, full_j)
    # the published configs at a 4-slot decode tick and a 2,048-token group
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for tokens in (4, 2048):
        assert tmoe._capacity(tokens, get_config(arch)) == \
            jmoe._capacity(tokens, jax_get_config(arch))
    assert tmoe._capacity(2048, get_config(arch)) == \
        {"deepseek-moe-16b": 240, "dbrx-132b": 640}[arch]


def _no_drop(cfg):
    """The same config with a capacity that drops nothing."""
    return cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.25, 1.25], ids=["drops", "cf1.25"])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("impl", ["onehot", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_forms_match_jax(arch, impl, groups, cf, dtype):
    """_moe_onehot / _moe_sort on (G, 40, D) groups against the reference's.
    At capacity factor 0.25 (C = 8 for 40 tokens x 2 choices over 8
    experts) pairs are dropped: the output differs from a no-drop run."""
    jcfg, tcfg, jp, tp = moe_pair(arch, dtype, capacity_factor=cf)
    jx, tx = inputs(3, (groups, 40, jcfg.d_model), dtype)
    jfn, tfn = {"onehot": (jmoe._moe_onehot, tmoe._moe_onehot),
                "sort": (jmoe._moe_sort, tmoe._moe_sort)}[impl]
    out = tfn(tp, tcfg, tx)
    assert out.dtype == TDT[dtype] and out.shape == tx.shape
    assert_close(out, jfn(jp, jcfg, jx), TOL[dtype])
    if cf == 0.25:
        free = tfn(tp, _no_drop(tcfg), tx).float()
        assert not torch.allclose(out.float(), free, atol=1e-3)


@pytest.mark.parametrize("impl", ["onehot", "sort"])
def test_dispatch_with_every_router_tie_matches_jax(impl):
    """A zero router sends every token to experts 0 and 1 (weights 1/2):
    the first C pairs of each are kept, the rest dropped, in both packages."""
    jcfg, tcfg, jp, tp = moe_pair("deepseek-moe-16b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = inputs(4, (2, 40, jcfg.d_model))
    jfn, tfn = {"onehot": (jmoe._moe_onehot, tmoe._moe_onehot),
                "sort": (jmoe._moe_sort, tmoe._moe_sort)}[impl]
    out = tfn(tp, tcfg, tx)
    assert_close(out, jfn(jp, jcfg, jx), 1e-5)
    C = tmoe._capacity(40, tcfg)                                  # 16
    assert bool((out[:, C:] == 0).all()) and bool((out[:, :C] != 0).any())


@pytest.mark.parametrize("impl", ["onehot", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, impl):
    """The whole layer, with the shared experts (deepseek) and without
    (dbrx): three groups of 16 tokens over a batch of 2, and one group."""
    jcfg, tcfg, jp, tp = moe_pair(arch)
    jx, tx = inputs(5, (2, 24, jcfg.d_model))
    for gs in (16, 2048):
        out = tmoe.apply_moe(tp, tcfg, tx, impl=impl, group_size=gs)
        assert_close(out, jmoe.apply_moe(jp, jcfg, jx, impl=impl,
                                         group_size=gs), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16_and_f32_match_jax_with_drops(arch, dtype):
    jcfg, tcfg, jp, tp = moe_pair(arch, dtype, capacity_factor=0.25)
    jx, tx = inputs(6, (3, 16, jcfg.d_model), dtype)
    for impl in ("onehot", "sort"):
        out = tmoe.apply_moe(tp, tcfg, tx, impl=impl, group_size=16)
        assert_close(out, jmoe.apply_moe(jp, jcfg, jx, impl=impl,
                                         group_size=16), TOL[dtype])


@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_equals_sort_in_the_port(arch, cf):
    _, tcfg, _, tp = moe_pair(arch, capacity_factor=cf)
    _, tx = inputs(7, (2, 48, tcfg.d_model))
    a = tmoe.apply_moe(tp, tcfg, tx, impl="onehot", group_size=32)
    b = tmoe.apply_moe(tp, tcfg, tx, impl="sort", group_size=32)
    assert_close(a, b, 1e-5)


def test_group_rule_and_unknown_impl_raise():
    """B·S not a multiple of the group size: the reference's assertion, as a
    ValueError with its message; an unknown impl: ValueError."""
    jcfg, tcfg, jp, tp = moe_pair("deepseek-moe-16b")
    jx, tx = inputs(8, (1, 40, jcfg.d_model))
    msg = "tokens 40 not divisible by group size 16"
    with pytest.raises(AssertionError, match=msg):
        jmoe.apply_moe(jp, jcfg, jx, group_size=16)
    for impl in tmoe.MOE_IMPL:
        with pytest.raises(ValueError, match=msg):
            tmoe.apply_moe(tp, tcfg, tx, impl=impl, group_size=16)
    assert tmoe.apply_moe(tp, tcfg, tx, group_size=20).shape == tx.shape
    with pytest.raises(ValueError, match="moe impl 'dense'"):
        tmoe.apply_moe(tp, tcfg, tx, impl="dense", group_size=20)


def test_sort_form_gives_the_same_bits_twice():
    _, tcfg, _, tp = moe_pair("dbrx-132b", capacity_factor=0.5)
    _, tx = inputs(9, (2, 64, tcfg.d_model))
    a = tmoe.apply_moe(tp, tcfg, tx, impl="sort", group_size=64)
    b = tmoe.apply_moe(tp, tcfg, tx, impl="sort", group_size=64)
    assert torch.equal(a, b)


def test_a_decode_tick_drops_nothing_and_slots_are_independent():
    """A tick routes its slot tokens as one group; at 4 slots C = 8 is at
    least the 4 pairs one expert can get, so each slot's output is what it
    gets routed alone (the published configs too: C = 8 at 4 tokens)."""
    _, tcfg, _, tp = moe_pair("deepseek-moe-16b")
    _, tx = inputs(10, (4, 1, tcfg.d_model))
    assert tmoe._capacity(4, tcfg) >= 4
    for impl in tmoe.MOE_IMPL:
        tick = tmoe.apply_moe(tp, tcfg, tx, impl=impl)
        for b in range(4):
            alone = tmoe.apply_moe(tp, tcfg, tx[b:b + 1], impl=impl)
            assert_close(tick[b], alone[0], 1e-6)
