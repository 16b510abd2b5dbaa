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


@pytest.mark.parametrize("L,groups,chunk,ns", [
    (1, 1, 64, 1), (64, 1, 64, 1),
    (4096, 16, 256, 16),          # gemma2-2b's ring: B=4 x 4 KV heads
    (8192, 16, 256, 32),          # gemma2-2b's full cache
    (2048, 4, 128, 16),           # recurrentgemma-2b's ring: B=4 x 1 KV head
    (524288, 1, 1024, 512)])      # at most MAX_SPLITS splits
def test_decode_split_plan(L, groups, chunk, ns):
    assert tdec.split_plan(L, groups) == (chunk, ns)
    assert chunk * ns >= L > chunk * (ns - 1)
    assert chunk % 64 == 0        # whole passes of a block's four warps


@pytest.mark.parametrize("S,Dh,B,H,tile", [
    (1000, 256, 1, 8, 64),        # gemma2-2b, 128 blocks on 132 SMs
    (1000, 256, 1, 10, 64),       # recurrentgemma-2b, 160 blocks
    (1500, 256, 1, 8, 32),        # 192 blocks
    (5000, 256, 1, 8, 32),        # gemma2-2b's 5000-token prefill
    (1000, 256, 2, 8, 32),        # a batch of two
    (5000, 128, 1, 8, 64),        # other head dims: always 64
    (1, 16, 1, 1, 64)])
def test_flash_key_tile(S, Dh, B, H, tile):
    assert tfa.key_tile(S, Dh, B, H, sms=132) == tile


def test_decode_counters_are_one_buffer_per_stream():
    """K3's merge counters: calls on one (device, stream) share a zeroed
    buffer, made once; another stream of the device gets its own."""
    cpu = torch.device("cpu")
    a = tdec._counter_buffer(cpu, 11, 16)
    assert tdec._counter_buffer(cpu, 11, 16) is a
    assert tdec._counter_buffer(cpu, 12, 16) is not a
    assert a.dtype == torch.int32 and not bool(a.any())
    big = tdec._counter_buffer(cpu, 11, 5000)       # a larger need: once more
    assert big.numel() >= 5000 and tdec._counter_buffer(cpu, 11, 16) is big


def test_decode_attention_raises_above_16_heads_per_kv_head():
    """One block serves a KV head's whole query group, at most 16 heads; the
    wrapper refuses more on every device (here the CPU)."""
    q = torch.zeros((1, 1, 17, 16))
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="17 query heads per KV head"):
        tdec.decode_attention(q, k, k, torch.ones(8, dtype=torch.bool))
    q16 = torch.zeros((1, 1, 32, 16))
    out = tdec.decode_attention(q16, torch.zeros((1, 8, 2, 16)),
                                torch.zeros((1, 8, 2, 16)),
                                torch.ones(8, dtype=torch.bool))
    assert out.shape == (1, 1, 32, 16)


# ------------------------------------- the bf16 tensor-core path, emulated

def tanh_kernel(x):
    """The bf16 kernels' tanh, 1 - 2 / (1 + 2^(2·log2(e)·x)), in f32.  (On the
    card 2^x and the division are the fast forms, 2^-22 relative each.)"""
    return 1.0 - 2.0 / (1.0 + torch.exp2(2.0 * 1.4426950408889634 * x))


def emulate_tensor_cores(q, k, v, ok, softcap, scale, tile):
    """The arithmetic of the kernels' bf16 path in plain PyTorch.

    q: (B,H,Sq,Dh), k,v: (B,H,Sk,Dh) bf16 (KV heads already repeated); ok:
    bool, broadcastable to (B,H,Sq,Sk).  Key tiles of ``tile`` in order, as the
    kernels loop: scores accumulated in f32 from bf16 operands, scaled, capped
    (by the kernels' tanh) and masked in f32; online softmax in f32; P rounded
    to bf16 before P·V, accumulated in f32; O / l at the end, rounded to bf16.
    """
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    ok = ok.expand(B, H, Sq, Sk)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    o = torch.zeros((B, H, Sq, Dh))
    for k0 in range(0, Sk, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * scale
        if softcap is not None:
            s = tanh_kernel(s / softcap) * softcap
        okt = ok[..., k0:k0 + tile]
        s = torch.where(okt, s, -1e30)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.where(okt, torch.exp(s - mx[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = mx
    return (o / torch.where(l > 0, l, 1.0)[..., None]).bfloat16()


def _bf16_inputs(B, Sq, Sk, H, KV, Dh, qmul=1.0):
    q, k, v = qkv(B, Sq, Sk, H, KV, Dh)
    return [to_torch(a, "bfloat16") for a in (q * qmul, k, v)]


def test_kernel_tanh_is_tanh_to_2e_7():
    """The formula, rounded as f32, is within 2e-7 of tanh everywhere and
    saturates to +-1 (the card's fast 2^x and division add about 1e-6: under
    a softcap of 50, 5e-5 of a score, far below the bf16 rounding of P)."""
    x = torch.linspace(-60.0, 60.0, 200001)
    err = (tanh_kernel(x) - torch.tanh(x.double()).float()).abs()
    assert float(err.max()) < 2e-7
    assert tanh_kernel(torch.tensor([-1e4, 1e4])).tolist() == [-1.0, 1.0]


def _heads_first(q, k, v, G):
    """(B,S,H,Dh) -> (B,H,S,Dh), K/V heads repeated for their query group."""
    return (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
            v.transpose(1, 2).repeat_interleave(G, dim=1))


@pytest.mark.parametrize("Dh,S,G,KV,window,softcap", [
    (16, 1, 1, 2, None, None),
    (16, 63, 2, 2, None, 50.0),
    (16, 65, 10, 1, 32, None),
    (16, 1024, 16, 1, 100, 50.0),
    (16, 1024, 1, 2, None, None),
    (256, 1, 16, 1, None, 50.0),
    (256, 64, 10, 1, 100, None),
    (256, 200, 2, 2, None, None),
    (256, 1024, 10, 1, 300, None),   # recurrentgemma-2b: 10 heads, a window
    (256, 1024, 2, 2, None, 50.0),   # gemma2-2b: 2 heads a KV head, softcap
])
def test_flash_tensor_core_arithmetic_holds_bf16_tolerance(Dh, S, G, KV, window,
                                                           softcap):
    """bf16 operands, f32 accumulation and P rounded to bf16, in the kernel's
    order over 64-key tiles, stay within the bf16 tolerance (2e-2) of the plain
    version, which the card holds the kernel to."""
    q, k, v = _bf16_inputs(1, S, S, G * KV, KV, Dh)
    scale = Dh ** -0.5
    r = torch.arange(S)[:, None]
    c = torch.arange(S)[None, :]
    ok = c <= r
    if window is not None:
        ok &= c > r - window
    got = emulate_tensor_cores(*_heads_first(q, k, v, G), ok, softcap, scale,
                               tile=64).transpose(1, 2)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window,
                                     softcap=softcap, scale=scale)
    assert got.shape == want.shape == (1, S, G * KV, Dh)
    assert_close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("Dh,L,G,KV,softcap,ring", [
    (16, 64, 1, 2, None, False),
    (16, 1024, 2, 2, 50.0, True),
    (16, 300, 10, 1, None, True),
    (16, 1024, 16, 1, 30.0, False),
    (256, 1024, 1, 2, 50.0, True),
    (256, 1024, 2, 2, 50.0, False),   # gemma2-2b's grouping
    (256, 1024, 10, 1, None, True),   # recurrentgemma-2b's ring
    (256, 500, 16, 1, None, False),
])
def test_decode_tensor_core_arithmetic_holds_bf16_tolerance(Dh, L, G, KV,
                                                            softcap, ring):
    """The same for one query token against a cache, over 16-key steps (a
    warp's step), per-slot masks, one slot fully masked (output 0)."""
    B = 3
    q, k, v = _bf16_inputs(B, 1, L, G * KV, KV, Dh)
    pos = np.array([L - 1, L // 3 + 5, 0])
    if ring:        # a ring of L slots holding the last L // 2 positions
        pos = pos + L
        slot_pos = pos[:, None] - np.mod(np.mod(pos[:, None], L)
                                         - np.arange(L)[None, :], L)
        valid = (slot_pos >= 0) & (slot_pos > pos[:, None] - L // 2)
    else:
        valid = np.arange(L)[None, :] <= pos[:, None]
    valid[2] = False                       # slot 2: no valid key at all
    valid = torch.from_numpy(valid)
    scale = Dh ** -0.5
    got = emulate_tensor_cores(*_heads_first(q, k, v, G),
                               valid[:, None, None, :], softcap, scale,
                               tile=16).transpose(1, 2)
    want = tdec.decode_attention_plain(q, k, v, valid, softcap=softcap,
                                       scale=scale)
    assert got.shape == want.shape == (B, 1, G * KV, Dh)
    assert_close(got, want, TOL["bfloat16"])
    assert float(got[2].abs().max()) == 0.0 == float(want[2].abs().max())


@pytest.mark.parametrize("Dh,S,G,KV,window,tile", [
    (16, 300, 2, 2, None, 64),
    (256, 1024, 2, 4, None, 32),     # gemma2-2b's grouping, the 32-key tile
    (256, 700, 2, 4, 500, 64),
])
def test_flash_tensor_core_arithmetic_at_the_softcap(Dh, S, G, KV, window, tile):
    """q scaled by 8: scores of std 8 and up to ~40, where tanh bends under a
    softcap of 50; the kernels' arithmetic still holds the bf16 tolerance."""
    q, k, v = _bf16_inputs(1, S, S, G * KV, KV, Dh, qmul=8.0)
    scale = Dh ** -0.5
    r = torch.arange(S)[:, None]
    c = torch.arange(S)[None, :]
    ok = c <= r
    if window is not None:
        ok &= c > r - window
    got = emulate_tensor_cores(*_heads_first(q, k, v, G), ok, 50.0, scale,
                               tile=tile).transpose(1, 2)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window,
                                     softcap=50.0, scale=scale)
    assert_close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("Dh,L,G,KV", [(16, 300, 10, 1), (256, 700, 2, 4)])
def test_decode_tensor_core_arithmetic_at_the_softcap(Dh, L, G, KV):
    """The same for one query token against a full cache, 16-key steps."""
    B = 2
    q, k, v = _bf16_inputs(B, 1, L, G * KV, KV, Dh, qmul=8.0)
    valid = torch.from_numpy(np.arange(L)[None, :]
                             <= np.array([L - 1, L // 3])[:, None])
    scale = Dh ** -0.5
    got = emulate_tensor_cores(*_heads_first(q, k, v, G),
                               valid[:, None, None, :], 50.0, scale,
                               tile=16).transpose(1, 2)
    want = tdec.decode_attention_plain(q, k, v, valid, softcap=50.0,
                                       scale=scale)
    assert_close(got, want, TOL["bfloat16"])
