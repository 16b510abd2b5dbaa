"""The port's recurrent kernels on the CPU: the plain PyTorch versions of K4
(``ssd_scan``) and K5 (``rg_lru``), which the wrappers use for a CPU tensor,
against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.ops``) AND against its sequential oracles
(``repro.kernels.ref``).  The twins of tests/test_kernels.py:100-175, same
shapes and tolerances: 2e-3 for the SSD scan (a chunked form against a
sequential recurrence, f32), 1e-5 for the RG-LRU (the same sequential
recurrence, f32).  Inputs are made once with numpy and handed to both.
"""
import numpy as np
import pytest
import torch

from _torch_port import assert_close, rnd, sigmoid, ssd_inputs, to_jax, to_torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as tlru
from repro_torch.kernels import ssd_scan as tssd

torch.set_num_threads(1)


# ---------------------------------------------------------------- SSD scan

@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 128, 2, 16, 16, 32),
    (2, 256, 4, 32, 64, 64),
    (1, 64, 24, 64, 128, 16),     # mamba2-130m head geometry
])
def test_ssd_scan_matches_jax_and_the_naive_recurrence(B, L, H, P, N, chunk):
    (x, dt, A, Bm, Cm), chunked = ssd_inputs(0, B, L, H, P, N, chunk)
    y, hlast = tops.ssd_scan(*(to_torch(a) for a in chunked))
    assert y.shape == (B, L, H, P) and hlast.shape == (B, H, P, N)
    assert y.dtype == torch.float32 and hlast.dtype == torch.float32
    jy, jh = jops.ssd_scan(*(to_jax(a) for a in chunked))
    y_ref, h_ref = jref.ssd_ref(*(to_jax(a) for a in (x, dt, A, Bm, Cm)))
    assert_close(y, jy, 2e-3)
    assert_close(hlast, jh, 2e-3)
    assert_close(y, y_ref, 2e-3)
    assert_close(hlast, h_ref, 2e-3)
    # the port's own sequential oracle is the JAX one
    ty, th = tref.ssd_ref(*(to_torch(a) for a in (x, dt, A, Bm, Cm)))
    assert_close(ty, y_ref, 1e-5)
    assert_close(th, h_ref, 1e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("seed", [0, 7, 19])
def test_ssd_chunk_size_invariance(chunk, seed):
    """Chunking must not change the SSD result (the twin of the hypothesis
    property, on fixed draws)."""
    (x, dt, A, Bm, Cm), chunked = ssd_inputs(seed, 1, 128, 2, 16, 16, chunk)
    y, h = tops.ssd_scan(*(to_torch(a) for a in chunked))
    y_ref, h_ref = tref.ssd_ref(*(to_torch(a) for a in (x, dt, A, Bm, Cm)))
    assert_close(y, y_ref, 2e-3)
    assert_close(h, h_ref, 2e-3)


def test_ssd_scan_plain_keeps_the_input_dtype_and_reads_views():
    """bf16 x/B/C come back as bf16 y and f32 state, and strided views (how
    the model hands over slices of one projection) give what copies give."""
    B, L, H, P, N, c = 1, 64, 2, 16, 16, 32
    (x, dt, A, Bm, Cm), chunked = ssd_inputs(3, B, L, H, P, N, c)
    xbc = np.concatenate([x.reshape(B, L, H * P), Bm, Cm], axis=-1)
    t = to_torch(xbc)
    nc = L // c
    views = (t[..., :H * P].reshape(B, nc, c, H, P), to_torch(chunked[1]),
             to_torch(chunked[3]), t[..., H * P:H * P + N].reshape(B, nc, c, N),
             t[..., H * P + N:].reshape(B, nc, c, N))
    assert not views[0].is_contiguous()
    y, h = tssd.ssd_scan(*views)
    want_y, want_h = tssd.ssd_scan_plain(
        *(to_torch(chunked[i]) for i in (0, 1, 3, 4, 5)))
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    bf = [v.to(torch.bfloat16) if v.dtype == torch.float32 and i in (0, 3, 4)
          else v for i, v in enumerate(views)]
    yb, hb = tssd.ssd_scan(*bf)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    assert_close(yb, want_y, 5e-2)


def test_ssd_scan_refuses_an_initial_state():
    _, chunked = ssd_inputs(0, 1, 32, 2, 16, 16, 32)
    args = [to_torch(a) for a in chunked]
    with pytest.raises(ValueError, match="zero state"):
        tops.ssd_scan(*args, h0=torch.zeros(1, 2, 16, 16))


# ---------------------------------------------------------------- RG-LRU

@pytest.mark.parametrize("B,S,W,bs,bw", [
    (2, 128, 64, 32, 64),
    (1, 256, 128, 128, 64),
    (3, 64, 256, 64, 128),
])
def test_rg_lru_matches_jax_and_the_sequential_oracle(B, S, W, bs, bw):
    a = sigmoid(rnd(0, (B, S, W)))                 # decay in (0,1)
    x = rnd(1, (B, S, W), 0.5)
    out = tops.rg_lru(to_torch(a), to_torch(x))
    assert out.shape == (B, S, W) and out.dtype == torch.float32
    assert_close(out, jops.rg_lru(to_jax(a), to_jax(x), block_w=bw, block_s=bs),
                 1e-5)
    assert_close(out, jref.rg_lru_ref(to_jax(a), to_jax(x)), 1e-5)


def test_rg_lru_with_initial_state():
    B, S, W = 1, 64, 32
    a = sigmoid(rnd(3, (B, S, W)))
    x = rnd(4, (B, S, W))
    h0 = rnd(5, (B, W))
    out = tops.rg_lru(to_torch(a), to_torch(x), to_torch(h0))
    assert_close(out, jops.rg_lru(to_jax(a), to_jax(x), to_jax(h0)), 1e-5)
    x2 = x.copy()
    x2[:, 0] += a[:, 0] * h0                        # folded by hand
    assert_close(out, jref.rg_lru_ref(to_jax(a), to_jax(x2)), 1e-5)


@pytest.mark.parametrize("B,S,W", [(2, 37, 100), (1, 1, 3), (1, 300, 33)])
def test_rg_lru_ragged_lengths_and_widths(B, S, W):
    """S and W that are no multiple of the Pallas blocks: its wrapper refuses
    them (rg_lru.py:48), so these are held against the jnp oracle only."""
    a = sigmoid(rnd(6, (B, S, W)))
    x = rnd(7, (B, S, W), 0.5)
    out = tops.rg_lru(to_torch(a), to_torch(x))
    assert_close(out, jref.rg_lru_ref(to_jax(a), to_jax(x)), 1e-5)


# ---------------------------------------------------------------- wrappers

def test_recurrent_ref_names_are_the_plain_versions():
    assert tref.rg_lru_ref is tlru.rg_lru_plain


def test_cpu_tensors_go_to_the_plain_versions_and_launch_nothing():
    before = (tssd.launches, tlru.launches)
    _, chunked = ssd_inputs(1, 1, 32, 2, 16, 16, 16)
    args = [to_torch(chunked[i]) for i in (0, 1, 3, 4, 5)]
    y, h = tssd.ssd_scan(*args)
    y2, h2 = tssd.ssd_scan_plain(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    a, x = to_torch(sigmoid(rnd(2, (1, 9, 5)))), to_torch(rnd(3, (1, 9, 5)))
    assert torch.equal(tlru.rg_lru(a, x), tlru.rg_lru_plain(a, x))
    assert (tssd.launches, tlru.launches) == before


def test_recurrent_wrappers_raise_on_a_device_without_a_kernel():
    t = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tlru.rg_lru(t, t)
    x = torch.empty((1, 1, 4, 2, 16), device="meta")
    d = torch.empty((1, 1, 4, 2), device="meta")
    b = torch.empty((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tssd.ssd_scan(x, d, d, b, b)
