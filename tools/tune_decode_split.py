#!/usr/bin/env python3
"""Time the decode-attention kernel over split sizes, on one CUDA device.

    python3 tools/tune_decode_split.py [--chunks 512 256 128 64]

For the three cache states of gemma2-2b's decode path (B=4, H=8, KV=4, Dh=256,
bf16, softcap 50) — a full cache at mixed positions, a full cache at the brim,
a ring buffer — and recurrentgemma-2b's 2048-slot ring (B=4, 10 heads on 1 KV
head, no softcap), fixes the keys per split (``decode_attention.split_plan``),
checks the kernel against its plain version, and prints the device time per
call (CUDA-graph replay over six copies of K/V, so the L2 is cold) beside the
bound, then ``torch.profiler``'s kernel launches per call and device time per
launch.  Finally the shipped plan's choice for each case.  Uses the timing
helpers of ``chip_smoke.py``; run it from the repo root.
"""
import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits if there is no CUDA device)
from repro_torch.kernels import decode_attention as k3  # noqa: E402

B, DH = 4, 256


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[256, 128, 64])
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    plan = k3.split_plan
    cases = [("full, mixed positions", 8192, 8, 4, 50.0,
              cs.full_valid(8192, [5015, 2063, 1015, 315])),
             ("full, at the brim", 8192, 8, 4, 50.0,
              cs.full_valid(8192, [8190, 8191, 8000, 8100])),
             ("ring", 4096, 8, 4, 50.0,
              cs.ring_valid(4096, 4096, [5015, 9000, 4096, 315])),
             ("recurrentgemma ring", 2048, 10, 1, None,
              cs.ring_valid(2048, 2048, [5015, 2063, 1015, 315]))]
    for label, L, H, KV, softcap, valid in cases:
        kw = dict(softcap=softcap, scale=DH ** -0.5)
        q = cs.randn(gen, (B, 1, H, DH), torch.bfloat16)
        sets = [(cs.randn(gen, (B, L, KV, DH), torch.bfloat16),
                 cs.randn(gen, (B, L, KV, DH), torch.bfloat16)) for _ in range(6)]
        want = k3.decode_attention_plain(q, *sets[0], valid, **kw)
        bound, by = cs.decode_bound_ms(B, H, KV, L, DH, valid, torch.bfloat16)
        for chunk in args.chunks + [None]:
            k3.split_plan = plan if chunk is None else \
                (lambda L, groups=1, c=chunk: (c, -(-L // c)))
            chunk = k3.split_plan(L, B * KV)[0]
            err = cs.compare(k3.decode_attention(q, *sets[0], valid, **kw),
                             want, 2e-2, f"{label} chunk {chunk}")
            calls = [lambda kk=kk, vv=vv: k3.decode_attention(q, kk, vv, valid, **kw)
                     for kk, vv in sets]
            ms = cs.device_ms(calls)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    for fn in calls:
                        fn()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if "decode_" in e.key and e.self_device_time_total > 0]
            n = sum(e.count for e in kern)
            us = sum(e.self_device_time_total for e in kern) / max(n, 1)
            print(f"{label}: L={L} H={H} KV={KV} valid keys={int(valid.sum())} "
                  f"chunk={chunk}{' (the plan)' if plan is k3.split_plan else ''}"
                  f" splits={k3.split_plan(L, B * KV)[1]}: {ms:.4f} ms "
                  f"({n / (5 * len(calls)):.0f} launch a call, {us:.1f} us "
                  f"each under the profiler), bound {bound:.4f} ms ({by}), "
                  f"max_abs_err {err:.2e}  [{name}]", flush=True)


if __name__ == "__main__":
    main()
