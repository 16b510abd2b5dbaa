"""Port kernels on the CPU: the plain PyTorch versions (which the wrappers use
for a CPU tensor) against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.ops``) AND against its pure-jnp oracles (``repro.kernels.ref``).

Same parametrisations and tolerances as tests/test_kernels.py: 2e-5 for
float32, 2e-2 for bfloat16 (bf16 rounds the output, and the inputs of both
sides are the same bf16 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close, rnd, to_jax, to_torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(B, Sq, Sk, H, KV, Dh):
    return (rnd(0, (B, Sq, H, Dh)), rnd(1, (B, Sk, KV, Dh)),
            rnd(2, (B, Sk, KV, Dh)))


# ---------------------------------------------------------------- flash attn

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh", [
    (1, 128, 128, 4, 4, 32),
    (2, 256, 256, 4, 2, 64),      # GQA
    (1, 128, 128, 4, 1, 64),      # MQA
])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None),
                                            (None, 30.0), (96, 50.0)])
def test_flash_attention_matches_jax(dtype, B, Sq, Sk, H, KV, Dh, window,
                                     softcap):
    q, k, v = qkv(B, Sq, Sk, H, KV, Dh)
    scale = Dh ** -0.5
    kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
    out = tops.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)), **kw)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    assert out.shape == (B, Sq, H, Dh) and out.dtype == to_torch(q, dtype).dtype
    assert_close(out, jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                           **kw), TOL[dtype])
    assert_close(out, jref.flash_attention_ref(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(None, 50.0), (16, 50.0)])
def test_flash_attention_ragged_length(window, softcap):
    """S=37 is no multiple of any block: the JAX kernel wrapper refuses it, so
    this case is held against the jnp oracle only."""
    q, k, v = qkv(1, 37, 37, 4, 2, 16)
    kw = dict(causal=True, window=window, softcap=softcap, scale=0.25)
    out = tops.flash_attention(*(to_torch(a) for a in (q, k, v)), **kw)
    want = jref.flash_attention_ref(*(to_jax(a) for a in (q, k, v)), **kw)
    assert_close(out, want, 2e-5)


def test_flash_ref_names_are_the_plain_versions():
    assert tref.flash_attention_ref is tfa.flash_attention_plain
    assert tref.decode_attention_ref is tdec.decode_attention_plain


def test_cpu_tensors_go_to_the_plain_version_and_launch_nothing():
    q, k, v = (to_torch(a) for a in qkv(1, 32, 32, 2, 1, 16))
    before = (tfa.launches, tdec.launches)
    a = tfa.flash_attention(q, k, v, scale=0.25)
    b = tfa.flash_attention_plain(q, k, v, scale=0.25)
    assert torch.equal(a, b)
    valid = torch.arange(32) <= 7
    c = tdec.decode_attention(q[:, :1], k, v, valid, scale=0.25)
    d = tdec.decode_attention_plain(q[:, :1], k, v, valid, scale=0.25)
    assert torch.equal(c, d)
    assert (tfa.launches, tdec.launches) == before


def test_wrappers_raise_on_a_device_without_a_kernel():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        tdec.decode_attention(q[:, :1], q, q, torch.empty(4, device="meta"))


# ---------------------------------------------------------------- flash decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,Dh,pos", [
    (2, 256, 4, 4, 32, 77),
    (1, 512, 8, 2, 64, 300),
    (2, 256, 4, 1, 128, 255),
])
def test_decode_attention_matches_jax(dtype, B, L, H, KV, Dh, pos):
    q, k, v = qkv(B, 1, L, H, KV, Dh)
    valid = np.arange(L) <= pos                      # (L,): broadcast by ops
    kw = dict(scale=Dh ** -0.5)
    out = tops.decode_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                                torch.from_numpy(valid), **kw)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    assert out.shape == (B, 1, H, Dh)
    assert_close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                            block_k=128, **kw), TOL[dtype])
    assert_close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid),
                                                **kw), TOL[dtype])


@pytest.mark.parametrize("pos", [0, 5, 127, 128, 200, 255])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_decode_attention_ring_mask(pos, softcap):
    """Arbitrary valid masks (ring buffers) stay close to both JAX versions."""
    B, L, H, KV, Dh = 1, 256, 2, 1, 32
    q, k, v = qkv(B, 1, L, H, KV, Dh)
    window = 128
    slot_pos = pos - np.mod(np.mod(pos, L) - np.arange(L), L)
    valid = (slot_pos >= 0) & (slot_pos > pos - window)
    kw = dict(scale=0.2, softcap=softcap)
    out = tops.decode_attention(*(to_torch(a) for a in (q, k, v)),
                                torch.from_numpy(valid), **kw)
    jq, jk, jv = (to_jax(a) for a in (q, k, v))
    assert_close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                            block_k=64, **kw), 2e-5)
    assert_close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid),
                                                **kw), 2e-5)


def test_decode_attention_per_slot_valid_and_fully_masked_row():
    """(B,L) masks, one slot with NO valid key.  The kernels (the Pallas one
    and the port's) force masked probabilities to 0, so that slot's output is
    0; the jnp oracle instead returns the mean of v there (a softmax over equal
    -1e30 scores).  So the masked slot is compared with the Pallas kernel and
    NOT with the oracle; the other slot with both."""
    B, L, H, KV, Dh = 2, 128, 4, 2, 32
    q, k, v = qkv(B, 1, L, H, KV, Dh)
    valid = np.zeros((B, L), bool)
    valid[0, :40] = True
    out = tops.decode_attention(*(to_torch(a) for a in (q, k, v)),
                                torch.from_numpy(valid), scale=0.2)
    jq, jk, jv = (to_jax(a) for a in (q, k, v))
    kern = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), scale=0.2,
                                 block_k=64)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid),
                                       scale=0.2)
    assert_close(out, kern, 2e-5)
    assert_close(out[0], oracle[0], 2e-5)
    assert float(out[1].abs().max()) == 0.0
    assert float(np.abs(np.asarray(oracle[1])).max()) > 1e-3


@pytest.mark.parametrize("L,chunk,ns", [(1, 128, 1), (64, 128, 1),
                                        (4096, 128, 32), (8192, 128, 64),
                                        (131072, 256, 512),
                                        (524288, 1024, 512)])
def test_decode_split_plan(L, chunk, ns):
    assert tdec.split_plan(L) == (chunk, ns)
    assert chunk * ns >= L > chunk * (ns - 1)
