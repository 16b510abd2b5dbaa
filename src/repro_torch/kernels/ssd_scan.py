"""Mamba2 SSD chunk scan: hand-written CUDA kernels + their plain PyTorch version.

Replaces the TPU kernel ``_ssd_kernel`` / ``ssd_scan_bhzc`` of
``src/repro/kernels/ssd_scan.py``.  Per (batch, head), over chunks of c steps
with ``cs`` the inclusive cumsum of A·dt inside each chunk:

    y      = (C · e^{cs}) @ stateᵀ + tril(C Bᵀ ⊙ e^{cs_i - cs_j} ⊙ dt_j) @ x
    state <- state · e^{cs_last} + (x ⊙ e^{cs_last - cs} dt)ᵀ B

The kernels are ``csrc/ssd_scan.cu`` (design notes at its top): the TPU kernel
carries the state from one chunk to the next in scratch, which needs its grid
to run in order; here chunk states, a serial pass over chunks, and the outputs
are three launches, each parallel over (batch, head, chunk), as the
reference's einsum path splits the work.  Two paths, by input type:

- bf16: the tensor cores (``mma.sync`` bf16 products, f32 accumulators).
  Rounded to bf16 on the way: seg·x before the state product, the weights
  C·Bᵀ ⊙ decay ⊙ dt before W·x, and the entering state before C·state.  P and
  N must be multiples of 16, and x, Bm and Cm need 16-byte aligned bases and
  strides that are multiples of 8 elements (16-byte ``cp.async`` loads).
- f32: the CUDA cores, f32 arithmetic throughout (2e-3 against the plain
  version; TF32 products would not hold it).

``ssd_scan`` launches the kernels for a CUDA tensor or raises; only a CPU
tensor goes to ``ssd_scan_plain``.  ``launches`` counts calls that launched
(the three kernels together).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

P_MAX, N_MAX = 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def ssd_scan_plain(x, dt, cs, Bm, Cm):
    """x: (B,nc,c,H,P); dt, cs: (B,nc,c,H) f32; Bm, Cm: (B,nc,c,N)
    -> (y: (B,nc,c,H,P) in x's dtype, h_last: (B,H,P,N) f32).

    The chunked form in f32 PyTorch ops.  e^{cs_i - cs_j} is taken only where
    j <= i (the exponent is -inf elsewhere), as the kernel does."""
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    dt, cs = dt.float(), cs.float()
    Bsz, nc, c, H, P = x.shape
    N = Bm.shape[-1]
    lower = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,c,c,H)
    decay = torch.exp(diff.masked_fill(~lower[None, None, :, :, None],
                                       float("-inf")))
    att = torch.einsum("bzin,bzjn->bzij", Cf, Bf)
    w = att[..., None] * decay * dt[:, :, None, :, :]
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", w, xf)
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dt                 # (B,nc,c,H)
    states = torch.einsum("bzch,bzchp,bzcn->bzhpn", seg, xf, Bf)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * torch.exp(cs[:, z, -1])[:, :, None, None] + states[:, z]
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", Cf, torch.exp(cs),
                         torch.stack(h_prev, dim=1))
    return (y_diag + y_off).to(x.dtype), h


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.repro_ssd_scan
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 22 + [ctypes.c_void_p])
        err = lib.repro_ssd_scan_error
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def _check(x, dt, cs, Bm, Cm):
    """Raises ValueError on what the kernels do not take.  Both paths: shapes
    that disagree, P > 64 or N > 128, a dtype other than float32 or bfloat16,
    operands of another type or device, a last dim that is not contiguous.
    The bf16 path also: P or N no multiple of 16, and x, Bm or Cm with a base
    that is not 16-byte aligned or a stride that is no multiple of 8."""
    if x.ndim != 5 or dt.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}")
    Bsz, nc, c, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (Bsz, nc, c, H) or cs.shape != dt.shape \
            or Bm.shape != (Bsz, nc, c, N) or Cm.shape != Bm.shape \
            or min(x.shape) < 1 or N < 1:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"cs {tuple(cs.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)} do not agree")
    if P > P_MAX or N > N_MAX:
        raise ValueError(f"ssd_scan: head dim {P} > {P_MAX} or state {N} > "
                         f"{N_MAX}: the kernel was not built for them")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} (float32, bfloat16)")
    for name, t, want in (("Bm", Bm, x.dtype), ("Cm", Cm, x.dtype),
                          ("dt", dt, torch.float32), ("cs", cs, torch.float32)):
        if t.dtype != want or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device}, "
                             f"want {want} on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a contiguous last dim; "
                             f"got strides {t.stride()}")
    if x.dtype != torch.bfloat16:
        return
    if P % 16 or N % 16:
        raise ValueError(f"ssd_scan: bf16 needs a head dim and a state that "
                         f"are multiples of 16; got P={P}, N={N}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"ssd_scan: bf16 {name} needs a 16-byte aligned "
                             f"base and strides that are multiples of 8; got "
                             f"strides {t.stride()} at offset "
                             f"{t.storage_offset()}")


def ssd_scan(x, dt, cs, Bm, Cm):
    """x: (B,nc,c,H,P); dt, cs: (B,nc,c,H) f32; Bm, Cm: (B,nc,c,N), x/Bm/Cm of
    one dtype (float32 or bfloat16) -> (y: (B,nc,c,H,P) in x's dtype,
    h_last: (B,H,P,N) f32).  Any c >= 1; P <= 64, N <= 128, in bf16 both
    multiples of 16.

    Read through their strides (views of the model's tensors are taken as they
    are); the last dim of x, Bm and Cm must be contiguous, and in bf16 their
    bases 16-byte aligned and their strides multiples of 8 (``_check``)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, cs, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _build.refuse_grad("ssd_scan", x, dt, cs, Bm, Cm)
    _check(x, dt, cs, Bm, Cm)
    Bsz, nc, c, H, P = x.shape
    N = Bm.shape[-1]

    fn, err = _kernel()
    y = torch.empty((Bsz, nc, c, H, P), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    # chunk states, then the states entering each chunk, (B,H,nc,N,P) f32
    st = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32, device=x.device)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), cs.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), h_last.data_ptr(), st.data_ptr(),
                _DTYPES[x.dtype], Bsz, nc, c, H, P, N,
                *x.stride()[:4], *dt.stride(), *cs.stride(),
                *Bm.stride()[:3], *Cm.stride()[:3], *y.stride()[:4], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: {err(rc).decode()}")
    launches += 1
    return y, h_last
