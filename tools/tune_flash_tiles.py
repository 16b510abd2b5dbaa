#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel with both key tiles at head_dim 256.

    python3 tools/tune_flash_tiles.py

The kernel is built once, with both tiles (BK = 32 and 64 keys).  The script
prints ptxas's registers and spills of both, then for each shape of a sweep
(gemma2-2b's global layer with softcap 50 and recurrentgemma-2b's local layer
with window 2048, S = 1000 ... 5000, and batches of 1-4) checks each tile
against the plain version and prints its device time, in the order 32, 64,
64, 32 within one process, with the grid's blocks per SM and the tile
``key_tile`` picks, beside the card's name and power limit.  Needs one CUDA
device; run it from the repo root.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, S, H, KV, window, softcap) at head_dim 256
SHAPES = [(1, S, 8, 4, None, 50.0) for S in (1000, 1500, 2000, 2500, 3000, 4000, 5000)]
SHAPES += [(1, S, 10, 1, 2048, None) for S in (1000, 1500, 2000, 2500, 3000, 4000, 5000)]
SHAPES += [(2, 1000, 8, 4, None, 50.0), (4, 1000, 8, 4, None, 50.0),
           (4, 500, 10, 1, 2048, None)]


def main():
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs  # exits if there is no CUDA device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", os.devnull, str(_build.CSRC / "flash_attention.cu")],
                         capture_output=True, text=True)
    lines = log.stdout.splitlines() + log.stderr.splitlines()
    for i, line in enumerate(lines):   # the entry, its registers, its spills
        if "Compiling entry" in line and "flash_mma_kernel" in line:
            print(" | ".join(x.strip() for x in lines[i:i + 4]))
    sms = torch.cuda.get_device_properties(cs.DEV).multi_processor_count
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    Dh = 256
    for (b, S, h, kv, window, softcap) in SHAPES:
        q = cs.randn(gen, (b, S, h, Dh), torch.bfloat16)
        k = cs.randn(gen, (b, S, kv, Dh), torch.bfloat16)
        v = cs.randn(gen, (b, S, kv, Dh), torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=softcap, scale=Dh ** -0.5)
        want = k2.flash_attention_plain(q, k, v, **kw)

        def run(bk):
            # lint: waive KL001 -- a timing tool: inputs from randn, no grad
            return k2._launch(q, k, v, kw["causal"], window, softcap,
                              kw["scale"], bk)
        errs = {bk: cs.compare(run(bk), want, 2e-2, f"bk={bk}") for bk in (32, 64)}
        del want
        ms = {32: [], 64: []}
        for bk in (32, 64, 64, 32):
            ms[bk].append(cs.device_ms([lambda: run(bk)]))
        blocks = b * h * -(-S // 64)
        t32, t64 = (sum(ms[bk]) / 2 for bk in (32, 64))
        print(f"B={b} S={S} H={h} KV={kv} window={window} softcap={softcap}: "
              f"{blocks} blocks ({blocks / sms:.2f} per SM), "
              f"bk=32 {ms[32][0]:.4f}/{ms[32][1]:.4f} ms, "
              f"bk=64 {ms[64][0]:.4f}/{ms[64][1]:.4f} ms, 64/32 {t64 / t32:.3f}, "
              f"max_abs_err {errs[32]:.2e}/{errs[64]:.2e}, key_tile picks "
              f"{k2.key_tile(S, Dh, b, h, sms)}  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
