"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's, from weights carried across by ``from_jax_params``: the block's
output and its prefill cache leaf by leaf, for the einsum path and the kernel
path (the port's ``ssd_scan`` plain version against the Pallas kernel in
interpret mode).  float32; 1e-4 (a few projections deep, each summed in
another order by the two CPU back ends).  Then, inside the port: prefill
followed by decode steps equals the forward at every position, including
prompts shorter than the conv window, and the cache is updated in place.
"""
import jax
import pytest
import torch

from _torch_port import (assert_close, assert_trees_close, config_pair,
                         numpy_tree, rnd, ssd_inputs, to_jax, to_torch)
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro_torch.models import from_jax_params
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = 1e-4


def block_params(jax_impl, torch_impl):
    """The first mamba2 layer of the reduced mamba2-130m, in both packages."""
    jcfg, tcfg = config_pair("mamba2-130m", jax_impl, torch_impl)
    jparams = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["stack"]["p0"]["mamba"])
    return jcfg, tcfg, jp, from_jax_params(numpy_tree(jp), device="cpu")


@pytest.fixture(scope="module", params=[("einsum", "einsum"),
                                        ("pallas", "cuda")],
                ids=lambda p: "-".join(p))
def block(request):
    return block_params(*request.param)


@pytest.mark.parametrize("S,chunk", [(40, 256), (64, 16), (3, 256)])
def test_apply_mamba_and_its_cache_match_jax(block, S, chunk):
    jcfg, tcfg, jp, tp = block
    x = rnd(11, (2, S, tcfg.d_model))
    with torch.no_grad():
        out, cache = tssm.apply_mamba(tp, tcfg, to_torch(x), chunk=chunk,
                                      return_cache=True)
    jout, jcache = jssm.apply_mamba(jp, jcfg, to_jax(x), chunk=chunk,
                                    return_cache=True)
    assert out.shape == (2, S, tcfg.d_model)
    assert_close(out, jout, TOL)
    assert_trees_close(cache, numpy_tree(jcache), TOL)


@pytest.mark.parametrize("n_pre", [1, 2, 5, 16])
@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_prefill_then_decode_equals_the_forward(impl, n_pre):
    """Prompts of 1 and 2 tokens are shorter than conv_width - 1 = 3: the
    port's cache holds them left-padded with zeros (what the forward's causal
    conv sees), so decode continues the forward exactly."""
    _, tcfg, _, tp = block_params("einsum", impl)
    S = n_pre + 6
    x = to_torch(rnd(12, (2, S, tcfg.d_model)))
    with torch.no_grad():
        full = tssm.apply_mamba(tp, tcfg, x)
        out, cache = tssm.apply_mamba(tp, tcfg, x[:, :n_pre], return_cache=True)
        assert cache["conv"].shape == (2, tcfg.conv_width - 1,
                                       tcfg.d_inner + 2 * tcfg.ssm_state)
        assert_close(out, full[:, :n_pre], TOL)
        for t in range(n_pre, S):
            y, cache2 = tssm.decode_mamba(tp, tcfg, x[:, t:t + 1], cache)
            assert cache2 is cache
            assert_close(y, full[:, t:t + 1], TOL)


def test_decode_writes_into_a_view_of_a_stacked_cache():
    """decode_stack keeps no returned cache: the block must write through the
    view it is given."""
    _, tcfg, _, tp = block_params("einsum", "einsum")
    stacked = {k: v.new_zeros((3,) + v.shape) for k, v in
               tssm.init_mamba_cache(tcfg, 2, device="cpu").items()}
    view = {k: v[1] for k, v in stacked.items()}
    x = to_torch(rnd(13, (2, 1, tcfg.d_model)))
    with torch.no_grad():
        _, new = tssm.decode_mamba(tp, tcfg, x, view)
    assert float(stacked["ssm"][1].abs().max()) > 0
    assert float(stacked["conv"][1, :, -1].abs().max()) > 0
    assert float(stacked["ssm"][0].abs().max()) == 0 == \
        float(stacked["ssm"][2].abs().max())
    assert new["ssm"].data_ptr() == stacked["ssm"][1].data_ptr()


@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_prompt_length_must_be_a_multiple_of_the_chunk(impl):
    """The reference's contract (ssm.py:82, :149): L a multiple of
    min(256, L).  300 is not; the reference asserts, the port raises."""
    _, tcfg, _, tp = block_params("einsum", impl)
    x = to_torch(rnd(14, (1, 300, tcfg.d_model)))
    with pytest.raises(ValueError, match="not divisible by chunk=256"):
        tssm.apply_mamba(tp, tcfg, x)
    assert tssm.apply_mamba(tp, tcfg, x[:, :256]).shape == (1, 256, 64)


def test_kernel_and_einsum_chunked_forms_agree_in_bf16():
    """ssd_chunked with the kernel's plain version (f32 inside) against the
    einsum form (which casts to bf16 where the reference does): 2e-2."""
    (x, dt, A, Bm, Cm), _ = ssd_inputs(5, 1, 64, 4, 16, 16, 16)
    args = [to_torch(x, "bfloat16"), to_torch(dt), to_torch(A),
            to_torch(Bm, "bfloat16"), to_torch(Cm, "bfloat16")]
    yk, hk = tssm.ssd_chunked(*args, 16, use_kernel=True)
    ye, he = tssm.ssd_chunked(*args, 16, use_kernel=False)
    assert yk.dtype == ye.dtype == torch.bfloat16
    assert_close(yk, ye, 2e-2)
    assert_close(hk, he.float(), 2e-2)
