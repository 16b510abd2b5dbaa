"""The port's recurrent kernels on the CPU: the plain PyTorch versions of K4
(``ssd_scan``) and K5 (``rg_lru``), which the wrappers use for a CPU tensor,
against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.ops``) AND against its sequential oracles
(``repro.kernels.ref``).  The twins of tests/test_kernels.py:100-175, same
shapes and tolerances: 2e-3 for the SSD scan (a chunked form against a
sequential recurrence, f32), 1e-5 for the RG-LRU (the same sequential
recurrence, f32).  Inputs are made once with numpy and handed to both.

K4's bf16 path runs on the tensor cores, which no CPU test can launch; an
emulation of its arithmetic in plain PyTorch (where it rounds to bf16) is held
here to the 2e-2 that ``chip_smoke.py`` holds the kernel to on the card, and
its wrapper's input checks (``_check``) are run on CPU tensors.  K5's
chunked scan is emulated the same way, in the order its kernel takes (f32
fmaf as an f64 product plus sum rounded once), and held to 1e-5 at full width
and at its chunk edges; its scratch sizing is checked against the CUDA
source's constants.
"""
import re

import numpy as np
import pytest
import torch

from _torch_port import (assert_close, rnd, sigmoid, softplus, ssd_inputs, to_jax,
                         to_torch)
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


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    """t as the kernel hands it to the tensor cores: hi = bf16(t) and
    lo = bf16(t - hi), two products summed in f32."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _ssd_tensor_core_emulation(x, dt, cs, Bm, Cm):
    """The arithmetic of ``ssd_scan``'s bf16 path (csrc/ssd_scan.cu): bf16
    operands, exact products summed in f32; seg·x rounded to bf16 once before
    the state product; W = C·Bᵀ ⊙ e^{cs_i - cs_j} ⊙ dt_j before W·x and the
    entering state before C·state as hi + lo bf16 pairs; y rounded at the
    end.  The carry over chunks and the final state stay f32."""
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    Bsz, nc, c, H, P = x.shape
    N = Bm.shape[-1]
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dt                 # (B,nc,c,H)
    states = torch.einsum("bzchp,bzcn->bzhpn", _bf16(seg[..., None] * xf), Bf)
    h = torch.zeros((Bsz, H, P, N))
    entering = []
    for z in range(nc):
        entering.append(h)
        h = h * torch.exp(cs[:, z, -1])[:, :, None, None] + states[:, z]
    ent = _hi_lo(torch.stack(entering, dim=1))                  # (B,nc,H,P,N)
    y_off = torch.exp(cs)[..., None] * torch.einsum("bzin,bzhpn->bzihp", Cf, ent)
    lower = torch.ones((c, c), dtype=torch.bool).tril()[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,i,j,H)
    decay = torch.exp(diff.masked_fill(~lower, float("-inf")))
    g = torch.einsum("bzin,bzjn->bzij", Cf, Bf)
    w = _hi_lo(g[..., None] * decay * dt[:, :, None, :, :])
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", w, xf)
    return (y_off + y_diag).to(torch.bfloat16), h


def _ssd_bf16_case(seed, B, nc, c, H, P, N):
    """As ``chip_smoke.ssd_case`` makes them: x, B and C bf16 views of one
    (B, S, H·P + 2N) projection scaled by 0.5; dt = softplus(·); A < 0; cs the
    cumsum of A·dt inside each chunk.  Also the model-layout f32 copies for
    the sequential oracle."""
    S = nc * c
    xbc = to_torch(rnd(seed, (B, S, H * P + 2 * N), 0.5)).to(torch.bfloat16)
    dt = softplus(rnd(seed + 1, (B, S, H)))
    A = -np.exp(rnd(seed + 2, (H,), 0.3))
    cs = np.cumsum((dt * A).reshape(B, nc, c, H), axis=2, dtype=np.float32)
    views = (xbc[..., :H * P].reshape(B, nc, c, H, P),
             to_torch(dt.reshape(B, nc, c, H)), to_torch(cs),
             xbc[..., H * P:H * P + N].reshape(B, nc, c, N),
             xbc[..., H * P + N:].reshape(B, nc, c, N))
    f = xbc.float().numpy()
    model = (f[..., :H * P].reshape(B, S, H, P), dt, A,
             f[..., H * P:H * P + N], f[..., H * P + N:])
    return views, model


@pytest.mark.parametrize("P,N", [(16, 16), (64, 128)])
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("c", [1, 16, 17, 64, 65, 256])
def test_ssd_bf16_tensor_core_arithmetic_holds_the_bf16_tolerance(c, nc, P, N):
    """Why the card may hold the bf16 kernel to 2e-2 (absolute plus relative)
    against its plain version: the same roundings, done here in plain
    PyTorch, stay within it, against the plain version (f32 arithmetic on the
    same bf16 inputs) and against the sequential oracle."""
    B, H = 1, 2
    views, model = _ssd_bf16_case(c + nc + P, B, nc, c, H, P, N)
    y, h = _ssd_tensor_core_emulation(*views)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    want_y, want_h = tssd.ssd_scan_plain(*views)
    assert_close(y, want_y, 2e-2)
    assert_close(h, want_h, 2e-2)
    ref_y, ref_h = jref.ssd_ref(*(to_jax(a) for a in model))
    assert_close(y.reshape(B, nc * c, H, P), ref_y, 2e-2)
    assert_close(h, ref_h, 2e-2)


@pytest.mark.parametrize("P,N", [(24, 16), (16, 24), (8, 128)])
def test_ssd_check_refuses_bf16_widths_that_are_no_multiple_of_16(P, N):
    views, _ = _ssd_bf16_case(0, 1, 1, 32, 2, P, N)
    with pytest.raises(ValueError, match="multiples of 16"):
        tssd._check(*views)
    # the f32 path (CUDA cores) takes any width up to 64 / 128
    tssd._check(*(v.float() for v in views))


def test_ssd_check_refuses_misaligned_bf16_views():
    B, nc, c, H, P, N = 1, 2, 32, 2, 16, 16
    S = nc * c
    dt = to_torch(softplus(rnd(1, (B, nc, c, H))))
    # x starting one element into the row: a base off the 16-byte grid
    xbc = torch.zeros((B, S, 1 + H * P + 2 * N), dtype=torch.bfloat16)
    args = (xbc[..., 1:1 + H * P].reshape(B, nc, c, H, P), dt, dt,
            xbc[..., 1 + H * P:1 + H * P + N].reshape(B, nc, c, N),
            xbc[..., 1 + H * P + N:].reshape(B, nc, c, N))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tssd._check(*args)
    # rows 4 elements longer than the three operands: strides no multiple of 8
    xbc = torch.zeros((B, S, H * P + 2 * N + 4), dtype=torch.bfloat16)
    args = (xbc[..., :H * P].reshape(B, nc, c, H, P), dt, dt,
            xbc[..., H * P:H * P + N].reshape(B, nc, c, N),
            xbc[..., H * P + N:H * P + 2 * N].reshape(B, nc, c, N))
    with pytest.raises(ValueError, match="multiples of 8"):
        tssd._check(*args)
    tssd._check(*(a.float() for a in args))      # f32 reads element by element


@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba2-130m reduced"])
def test_ssd_check_takes_the_views_the_model_hands_over(arch):
    """apply_mamba's x, B and C are views of one (B, S, H·P + 2N) projection
    (offsets 0, H·P, H·P + N): in bf16 they meet the kernel's limits."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config("mamba2-130m")
    if arch.endswith("reduced"):
        cfg = reduced(cfg)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    views, _ = _ssd_bf16_case(0, 1, 2, 16, H, P, N)
    assert views[0].dtype == torch.bfloat16 and not views[0].is_contiguous()
    tssd._check(*views)


def test_ssd_check_refuses_shapes_and_types_that_disagree():
    views, _ = _ssd_bf16_case(0, 1, 1, 16, 2, 16, 16)
    x, dt, cs, Bm, Cm = views
    with pytest.raises(ValueError, match="do not agree"):
        tssd._check(x, dt, cs[:, :, :8], Bm, Cm)
    with pytest.raises(ValueError, match="Cm is torch.float32"):
        tssd._check(x, dt, cs, Bm, Cm.float())
    with pytest.raises(ValueError, match="head dim 80 > 64"):
        tssd._check(torch.zeros((1, 1, 16, 2, 80), dtype=torch.bfloat16),
                    dt, cs, Bm, Cm)


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


def _fma(p, q, r):
    """fmaf: an f64 product plus sum (exact product), rounded once to f32."""
    return (p.astype(np.float64) * q + r).astype(np.float32)


def anchored_carry(P, E):
    """The state entering each chunk as csrc/rg_lru.cu takes it: every
    ANCHOR-th chunk publishes (0, its inclusive state), the others (P, E), and
    chunk i folds from 0 the slots of chunks g .. i-1, g the last anchor below
    i.  P, E: (B, nc, W) -> (B, nc, W)."""
    K = tlru.ANCHOR
    slot_p, slot_e = P.copy(), E.copy()
    enter = np.zeros_like(E)
    for i in range(P.shape[1]):
        if i > 0:
            c = np.zeros_like(E[:, 0])
            for j in range((i - 1) // K * K, i):
                c = _fma(slot_p[:, j], c, slot_e[:, j])
            enter[:, i] = c
        if i % K == 0:
            slot_p[:, i] = 0.0
            slot_e[:, i] = _fma(P[:, i], enter[:, i], E[:, i])
    return enter


def sequential_carry(P, E):
    """c_0 = 0, c_{j+1} = fmaf(P_j, c_j, E_j): the one fixed order."""
    enter = np.zeros_like(E)
    run = np.zeros_like(E[:, 0])
    for i in range(P.shape[1]):
        enter[:, i] = run
        run = _fma(P[:, i], run, E[:, i])
    return enter


def emulate_rg_lru_kernel(a, x, carry=anchored_carry):
    """csrc/rg_lru.cu's arithmetic in numpy, in the kernel's order: per-warp
    scans of ROWS rows from 0 (and the rows' product), the warps folded in
    order into each chunk's aggregate (P, E), the state entering each chunk
    (``carry``), the warps' entering states in order, and the rescan."""
    R, NW = tlru.ROWS, tlru.WARPS
    B, S, W = a.shape
    nc = -(-S // tlru.CHUNK)
    pad = ((0, 0), (0, nc * tlru.CHUNK - S), (0, 0))
    a = np.pad(a, pad, constant_values=1.0).reshape(B, nc, NW, R, W)
    x = np.pad(x, pad, constant_values=0.0).reshape(B, nc, NW, R, W)
    end = np.zeros((B, nc, NW, W), np.float32)
    prod = np.ones((B, nc, NW, W), np.float32)
    for r in range(R):
        end = _fma(a[:, :, :, r], end, x[:, :, :, r])
        prod = prod * a[:, :, :, r]
    P = np.ones((B, nc, W), np.float32)
    E = np.zeros((B, nc, W), np.float32)
    for w in range(NW):
        E = _fma(prod[:, :, w], E, end[:, :, w])
        P = P * prod[:, :, w]
    enter = carry(P, E)
    h = np.empty_like(a)
    for w in range(NW):
        hv = enter
        for r in range(R):
            hv = h[:, :, w, r] = _fma(a[:, :, w, r], hv, x[:, :, w, r])
        enter = _fma(prod[:, :, w], enter, end[:, :, w])
    return h.reshape(B, nc * tlru.CHUNK, W)[:, :S]


def lru_inputs(seed, B, S, W, kind):
    """As chip_smoke.py phase 3 makes them: a = sigmoid(r), x / 2; or a near 1
    (long memory) with x scaled by sqrt(1 - a^2), as the model gates it."""
    r, x = rnd(seed, (B, S, W)), rnd(seed + 1, (B, S, W))
    if kind == "sigmoid":
        return sigmoid(r), (x * 0.5).astype(np.float32)
    a = (1.0 - 0.01 * sigmoid(r)).astype(np.float32)
    return a, (x * np.sqrt(1.0 - a * a)).astype(np.float32)


@pytest.mark.parametrize("kind", ["near 1", "sigmoid"])
def test_rg_lru_kernel_arithmetic_at_full_width(kind):
    """recurrentgemma-2b's heaviest prefill, B=1 S=5000 W=2560: the kernel's
    chunked order of fmaf against the sequential oracles, 1e-5."""
    a, x = lru_inputs(11, 1, 5000, 2560, kind)
    got = emulate_rg_lru_kernel(a, x)
    assert_close(got, jref.rg_lru_ref(to_jax(a), to_jax(x)), 1e-5)
    assert_close(got, tlru.rg_lru_plain(to_torch(a), to_torch(x)), 1e-5)
    # the anchors change who folds a prefix, not a bit of the result
    assert np.array_equal(got, emulate_rg_lru_kernel(a, x, sequential_carry))


@pytest.mark.parametrize("W", [33, 100])
@pytest.mark.parametrize("S", [1, tlru.ROWS - 1, tlru.ROWS, tlru.ROWS + 1,
                               tlru.CHUNK - 1, tlru.CHUNK, tlru.CHUNK + 1,
                               2 * tlru.CHUNK + 1, tlru.ANCHOR * tlru.CHUNK,
                               tlru.ANCHOR * tlru.CHUNK + 1])
def test_rg_lru_kernel_arithmetic_at_the_chunk_edges(S, W):
    """One warp's rows, one block's chunk and three chunks, each one row
    short, exact and one row over, and the first anchor's chunk (the last one
    without, the first one with an anchor beyond chunk 0), with a ragged
    channel tile."""
    a, x = lru_inputs(S + W, 2, S, W, "near 1" if S % 2 else "sigmoid")
    got = emulate_rg_lru_kernel(a, x)
    assert got.shape == (2, S, W)
    assert np.array_equal(got, emulate_rg_lru_kernel(a, x, sequential_carry))
    assert_close(got, jref.rg_lru_ref(to_jax(a), to_jax(x)), 1e-5)
    assert_close(got, tlru.rg_lru_plain(to_torch(a), to_torch(x)), 1e-5)


def test_rg_lru_geometry_matches_the_cuda_source():
    """The wrapper sizes scratch with constants that csrc/rg_lru.cu defines."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "rg_lru.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    names = ("CH", "WARPS", "ROWS", "ANCHOR", "HEADER", "COUNT_BITS")
    assert {k: int(const[k]) for k in names} == \
        {k: getattr(tlru, k) for k in names}
    assert "constexpr int SLOT = CH;" in src and tlru.SLOT == tlru.CH
    # the slot words are read as device-scope relaxed loads (through L2),
    # never through the non-coherent path
    assert "__ldg" not in src and "ld_relaxed_u64(" in src


def test_rg_lru_scratch_sizing_and_growth():
    """tiles x chunks x batch blocks, one slot each; the buffer is made once
    per (device, stream) and remade larger (zeroed) only when a call needs
    more."""
    assert tlru.geometry(1, 5000, 2560) == (80, 40, 3200)
    assert tlru.geometry(1, 37, 2560) == (80, 1, 80)
    assert tlru.geometry(4, tlru.CHUNK + 1, 33) == (2, 2, 16)
    assert tlru.scratch_words(1, 5000, 2560) == tlru.HEADER + 2 * 3200 * tlru.SLOT
    key = (torch.device("cpu"), -12345)
    tlru._scratch.pop(key, None)
    try:
        short = tlru._scratch_buffer(key[0], key[1], tlru.scratch_words(1, 37, 2560))
        assert short.numel() == tlru.MIN_WORDS and short.dtype == torch.int64
        assert not short.any()
        short[0] = 7
        same = tlru._scratch_buffer(key[0], key[1],
                                    tlru.scratch_words(1, 5000, 2560))
        assert same is short
        need = tlru.scratch_words(4, 8192, 2560)
        assert need > tlru.MIN_WORDS
        grown = tlru._scratch_buffer(key[0], key[1], need)
        assert grown is not short and grown.numel() == need
        assert not grown.any()
        assert tlru._scratch_buffer(key[0], key[1], 5) is grown
    finally:
        tlru._scratch.pop(key, None)


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
