"""The model code's device-mesh forms, on plain CPU tensors.

Where a ``DTensor`` cannot run the one-card form of a function, the port
takes another form on a device mesh (``sharding.is_split`` decides).  The
dry-run counts those forms' collectives over a fake process group, which
moves no data, so their values are checked here instead: each form runs on
plain tensors (its module's ``is_split`` forced true) and is held to the
one-card form on the same inputs, and to the JAX package where it has the
function.  Exact where the two forms do the same arithmetic in the same
order; else float32 within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close, config_pair, numpy_tree, rnd, to_jax, \
    to_torch
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models.params import ParamStore as JaxParamStore
from repro_torch.models import attention as ta
from repro_torch.models import from_jax_params
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

TOL = 1e-5


def _split(monkeypatch, module):
    """Take ``module``'s device-mesh branches on plain tensors."""
    monkeypatch.setattr(module, "is_split", lambda x, *dims: True)


def _scatter_ring(t, S, L):
    """The ring buffer by an index scatter: position i at slot i % L."""
    n = min(S, L)
    out = t.new_zeros((t.shape[0], L) + t.shape[2:])
    out[:, torch.arange(S - n, S) % L] = t[:, S - n:]
    return out


@pytest.mark.parametrize("S,L", [(1, 8), (5, 8), (8, 8), (13, 8), (16, 8),
                                 (31, 8)],
                         ids=["one", "short", "full", "wrap", "twice",
                              "wrap3"])
def test_ring_equals_the_index_scatter(S, L):
    t = to_torch(rnd(0, (2, S, 3, 4)))
    got = ta._ring(t, S, L)
    assert torch.equal(got, _scatter_ring(t, S, L))
    # a new tensor: decode writes into the cache in place
    assert got.is_contiguous() and got.data_ptr() != t.data_ptr()


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 12, None), (True, None, 30.0),
    (False, None, None)], ids=["causal", "window", "softcap", "full"])
def test_cp_local_row_slices_equal_blocked_attention(causal, window,
                                                     softcap):
    """Each device's rows (``row0`` = its first global row) against the
    whole K/V, concatenated over 4 devices, equal the blocked form."""
    B, S, H, KV, Dh, dev = 2, 32, 4, 2, 8, 4
    q = to_torch(rnd(0, (B, S, H, Dh)))
    k = to_torch(rnd(1, (B, S, KV, Dh)))
    v = to_torch(rnd(2, (B, S, KV, Dh)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=Dh ** -0.5, scores_f32=True)
    want = ta._attend_blocked(q, k, v, chunk=8, **kw)
    n = S // dev
    got = torch.cat([ta._attend_cp_local(q[:, r:r + n], k, v, row0=r,
                                         chunk=4, **kw)
                     for r in range(0, S, n)], dim=1)
    assert_close(got, want, TOL)


def test_select_write_equals_the_index_write(monkeypatch):
    """The select-written decode rows (every batch row at its own slot)
    equal the index write, bit for bit, f32 and int8."""
    B, L = 3, 8
    slot = torch.tensor([0, 5, 7])
    rows = torch.arange(B)
    for dtype in (torch.float32, torch.int8):
        cache = to_torch(rnd(0, (B, L, 2, 4)) * 50).to(dtype)
        new = to_torch(rnd(1, (B, 2, 4)) * 50).to(dtype)
        want = cache.clone()
        want[rows, slot] = new
        _split(monkeypatch, ta)
        got = cache.clone()
        ta._write_slots(got, rows, slot, new)
        monkeypatch.undo()
        assert torch.equal(got, want)


def test_split_logsumexp_cross_entropy(monkeypatch):
    """The max-and-sum logsumexp of a split vocabulary: the same loss as
    ``torch.logsumexp``'s and the reference's, with and without a mask."""
    logits = rnd(0, (2, 5, 32), 8.0)          # large: the max matters
    labels = np.random.default_rng(1).integers(0, 32, (2, 5))
    mask = (np.random.default_rng(2).random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        tm = None if m is None else to_torch(m)
        jm = None if m is None else to_jax(m)
        plain = tl.cross_entropy(to_torch(logits), torch.from_numpy(labels),
                                 tm)
        _split(monkeypatch, tl)
        got = tl.cross_entropy(to_torch(logits), torch.from_numpy(labels), tm)
        monkeypatch.undo()
        assert_close(got, plain, TOL)
        assert_close(got, jl.cross_entropy(to_jax(logits), jnp.asarray(labels),
                                           jm), TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_select_masked_padding_columns(monkeypatch, tied):
    """The padded vocabulary's columns masked by a select equal the fill,
    bit for bit, and the reference's within 1e-5."""
    jcfg, tcfg = config_pair("gemma2-2b", vocab_size=250, tie_embeddings=tied)
    D, V = jcfg.d_model, jcfg.padded_vocab
    p = {"embed": {"tok": rnd(0, (V, D), 0.5), "head": rnd(1, (D, V), 0.5)}}
    x = rnd(2, (2, 3, D), scale=4.0)
    tp = {"embed": {k: to_torch(v) for k, v in p["embed"].items()}}
    plain = tl.lm_logits(tp, tcfg, to_torch(x))
    _split(monkeypatch, tl)
    got = tl.lm_logits(tp, tcfg, to_torch(x))
    assert torch.equal(got, plain)
    jp = {"embed": {k: to_jax(v) for k, v in p["embed"].items()}}
    assert_close(got, jl.lm_logits(jp, jcfg, to_jax(x)), TOL)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_moe_product_combine_equals_the_einsum(monkeypatch, arch):
    """The one-product combine over (expert, slot) of split experts: the
    einsum's result and the reference's, within 1e-5 (another summation
    order), with pairs dropped at capacity factor 0.25."""
    jcfg, tcfg = config_pair(arch, capacity_factor=0.25)
    ps = JaxParamStore(jax.random.PRNGKey(0), jnp.float32)
    jmoe.init_moe(ps, "moe", jcfg, None)
    jp = ps.params["moe"]
    tp = from_jax_params(numpy_tree(jp), device="cpu")
    x = rnd(3, (3, 40, jcfg.d_model))
    plain = tmoe._moe_onehot(tp, tcfg, to_torch(x))
    _split(monkeypatch, tmoe)
    got = tmoe._moe_onehot(tp, tcfg, to_torch(x))
    assert_close(got, plain, TOL)
    assert_close(got, jmoe._moe_onehot(jp, jcfg, jnp.asarray(x)), TOL)
    assert math.isfinite(float(got.abs().max()))
