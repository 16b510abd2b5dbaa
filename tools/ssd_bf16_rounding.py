#!/usr/bin/env python3
"""Where K4's bf16 path may round, on the CPU: each choice against the 2e-2.

    PYTHONPATH=src python3 tools/ssd_bf16_rounding.py [--seq 1024] [--seeds 3]

The bf16 kernel (``csrc/ssd_scan.cu``) feeds the tensor cores bf16 operands
and sums in f32.  Three of its operands are f32 values it has computed: seg·x
(state product), W = C·Bᵀ ⊙ e^{cs_i - cs_j} ⊙ dt_j (W·x) and the entering
state (C·state).  Each can go in rounded to bf16 once, or as a pair hi =
bf16(v), lo = bf16(v - hi) at the cost of a second product.  This emulates the
kernel's arithmetic in plain PyTorch for each choice, at mamba2-130m's
geometry (H=24, P=64, N=128, chunk 256) on inputs made as ``chip_smoke.py``
makes them, and prints the largest |y - plain| / (1 + |plain|) against
``ssd_scan.ssd_scan_plain``: ``chip_smoke.py`` fails a kernel above 0.02.
No card is needed; the numbers are the same on any machine.
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan_plain


def bf16(t):
    return t.to(torch.bfloat16).float()


def hi_lo(t):
    hi = bf16(t)
    return hi + bf16(t - hi)


def emulate(x, dt, cs, Bm, Cm, seg_x, w, state):
    """The kernel's arithmetic with ``bf16`` or ``hi_lo`` for each operand."""
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    Bsz, nc, c, H, P = x.shape
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dt
    states = torch.einsum("bzchp,bzcn->bzhpn", seg_x(seg[..., None] * xf), Bf)
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]))
    entering = []
    for z in range(nc):
        entering.append(h)
        h = h * torch.exp(cs[:, z, -1])[:, :, None, None] + states[:, z]
    ent = state(torch.stack(entering, dim=1))
    y_off = torch.exp(cs)[..., None] * torch.einsum("bzin,bzhpn->bzihp", Cf, ent)
    lower = torch.ones((c, c), dtype=torch.bool).tril()[None, None, :, :, None]
    decay = torch.exp((cs[:, :, :, None, :] - cs[:, :, None, :, :])
                      .masked_fill(~lower, float("-inf")))
    g = torch.einsum("bzin,bzjn->bzij", Cf, Bf)
    y_diag = torch.einsum("bzijh,bzjhp->bzihp",
                          w(g[..., None] * decay * dt[:, :, None, :, :]), xf)
    return (y_off + y_diag).to(torch.bfloat16)


def case(seed, S, H=24, P=64, N=128, c=256):
    """As ``chip_smoke.ssd_case``: bf16 views of one (1, S, H·P + 2N)
    projection scaled by 0.5, dt = softplus(·), A < 0, cs per chunk."""
    gen = torch.Generator().manual_seed(seed)
    nc = S // c
    xbc = (torch.randn((1, S, H * P + 2 * N), generator=gen) * 0.5).to(torch.bfloat16)
    dt = F.softplus(torch.randn((1, S, H), generator=gen)).reshape(1, nc, c, H)
    A = -torch.exp(torch.randn((H,), generator=gen) * 0.3)
    return (xbc[..., :H * P].reshape(1, nc, c, H, P), dt,
            torch.cumsum(dt * A, dim=2),
            xbc[..., H * P:H * P + N].reshape(1, nc, c, N),
            xbc[..., H * P + N:].reshape(1, nc, c, N))


CHOICES = {
    "one rounding each (seg.x, W, state)": (bf16, bf16, bf16),
    "W once, others hi+lo": (hi_lo, bf16, hi_lo),
    "state once, others hi+lo": (hi_lo, hi_lo, bf16),
    "seg.x once, others hi+lo (the kernel)": (bf16, hi_lo, hi_lo),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(4)
    inputs = [case(s, args.seq) for s in range(args.seeds)]
    plains = [ssd_scan_plain(*a)[0].float() for a in inputs]
    print(f"mamba2-130m geometry, S={args.seq}, seeds 0-{args.seeds - 1}: "
          "max |y - plain| / (1 + |plain|) (chip_smoke.py fails above 0.02)")
    for name, (seg_x, w, state) in CHOICES.items():
        worst = max(float(((emulate(*a, seg_x, w, state).float() - p).abs()
                           / (1 + p.abs())).max())
                    for a, p in zip(inputs, plains))
        print(f"  {name:40s} {worst:.4f}")


if __name__ == "__main__":
    main()
