"""The port's Griffin recurrent block (``repro_torch.models.griffin``) against
the JAX package's, from weights carried across by ``from_jax_params``: the
block's output and its prefill cache leaf by leaf, for the scan path (a
doubling scan against ``associative_scan``) and the kernel path (the port's
``rg_lru`` plain version against the Pallas kernel in interpret mode).
float32; 1e-4 (a few projections deep, each summed in another order by the two
CPU back ends).  Then, inside the port: prefill followed by decode steps equals
the forward at every position, including prompts shorter than the conv
window, and the cache is updated in place.
"""
import jax
import pytest
import torch

from _torch_port import (assert_close, assert_trees_close, config_pair,
                         numpy_tree, rnd, sigmoid, to_jax, to_torch)
from repro.models import build_model as jax_build_model
from repro.models import griffin as jgriffin
from repro_torch.kernels import ref as tref
from repro_torch.models import from_jax_params
from repro_torch.models import griffin as tgriffin

torch.set_num_threads(1)

TOL = 1e-4


def block_params(jax_impl, torch_impl):
    """The first rglru layer of the reduced recurrentgemma-2b, in both
    packages."""
    jcfg, tcfg = config_pair("recurrentgemma-2b", jax_impl, torch_impl)
    jparams = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["stack"]["p0"]["rec"])
    return jcfg, tcfg, jp, from_jax_params(numpy_tree(jp), device="cpu")


@pytest.fixture(scope="module", params=[("einsum", "einsum"),
                                        ("pallas", "cuda")],
                ids=lambda p: "-".join(p))
def block(request):
    return block_params(*request.param)


@pytest.mark.parametrize("S", [40, 64, 3])
def test_apply_griffin_and_its_cache_match_jax(block, S):
    jcfg, tcfg, jp, tp = block
    x = rnd(21, (2, S, tcfg.d_model))
    with torch.no_grad():
        out, cache = tgriffin.apply_griffin(tp, tcfg, to_torch(x),
                                            return_cache=True)
    jout, jcache = jgriffin.apply_griffin(jp, jcfg, to_jax(x),
                                          return_cache=True)
    assert out.shape == (2, S, tcfg.d_model)
    assert_close(out, jout, TOL)
    assert_trees_close(cache, numpy_tree(jcache), TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_rg_lru_scan_with_an_initial_state_matches_jax(use_kernel):
    jcfg, tcfg, jp, tp = block_params("einsum", "einsum")
    u = rnd(22, (2, 37, tcfg.lru_width))
    h0 = rnd(23, (2, tcfg.lru_width))
    h, h_last = tgriffin.rg_lru_scan(tp, to_torch(u), to_torch(h0), use_kernel)
    jh, jh_last = jgriffin.rg_lru_scan(jp, to_jax(u), to_jax(h0))
    assert_close(h, jh, 1e-5)
    assert_close(h_last, jh_last, 1e-5)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 77])
def test_doubling_scan_equals_the_sequential_recurrence(S):
    a = to_torch(sigmoid(rnd(24, (3, S, 16))))
    x = to_torch(rnd(25, (3, S, 16)))
    assert_close(tgriffin._doubling_scan(a, x), tref.rg_lru_ref(a, x), 1e-5)


@pytest.mark.parametrize("n_pre", [1, 2, 5, 16])
@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_prefill_then_decode_equals_the_forward(impl, n_pre):
    """Prompts of 1 and 2 tokens are shorter than conv_width - 1 = 3: the
    port's cache holds them left-padded with zeros (what the forward's causal
    conv sees), so decode continues the forward exactly."""
    _, tcfg, _, tp = block_params("einsum", impl)
    S = n_pre + 6
    x = to_torch(rnd(26, (2, S, tcfg.d_model)))
    with torch.no_grad():
        full = tgriffin.apply_griffin(tp, tcfg, x)
        out, cache = tgriffin.apply_griffin(tp, tcfg, x[:, :n_pre],
                                            return_cache=True)
        assert cache["conv"].shape == (2, tcfg.conv_width - 1, tcfg.lru_width)
        assert_close(out, full[:, :n_pre], TOL)
        for t in range(n_pre, S):
            y, cache2 = tgriffin.decode_griffin(tp, tcfg, x[:, t:t + 1], cache)
            assert cache2 is cache
            assert_close(y, full[:, t:t + 1], TOL)


def test_decode_writes_into_a_view_of_a_stacked_cache():
    """decode_stack keeps no returned cache: the block must write through the
    view it is given."""
    _, tcfg, _, tp = block_params("einsum", "einsum")
    stacked = {k: v.new_zeros((3,) + v.shape) for k, v in
               tgriffin.init_griffin_cache(tcfg, 2, device="cpu").items()}
    view = {k: v[1] for k, v in stacked.items()}
    x = to_torch(rnd(27, (2, 1, tcfg.d_model)))
    with torch.no_grad():
        _, new = tgriffin.decode_griffin(tp, tcfg, x, view)
    assert float(stacked["h"][1].abs().max()) > 0
    assert float(stacked["conv"][1, :, -1].abs().max()) > 0
    assert float(stacked["h"][0].abs().max()) == 0 == \
        float(stacked["h"][2].abs().max())
    assert new["h"].data_ptr() == stacked["h"][1].data_ptr()
