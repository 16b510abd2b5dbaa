#!/usr/bin/env python3
"""Time the bf16 SSD scan (K4) of one source tree, for A/B comparisons.

    python3 tools/ssd_ab.py [SRC_DIR]

At mamba2-130m's geometry (H=24, P=64, N=128, chunk 256, bf16, inputs made as
``chip_smoke.py`` makes them) over S = 256 ... 8192 and batches of 2 and 4,
checks ``ssd_scan`` against its plain version (2e-2) and prints its device
time per call (CUDA-graph replay, CUDA events).  ``SRC_DIR`` (default: this
checkout's ``src``) may be the ``src`` of another commit unpacked beside it.
Two versions are compared inside ONE job on one card, in turns:

    for t in parent/src src src parent/src; do python3 tools/ssd_ab.py $t; done

Needs one CUDA device.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
H, P, N, C = 24, 64, 128, 256
SHAPES = [(1, S) for S in (256, 512, 1024, 2048, 4096, 8192)] + [(2, 1024), (4, 1024)]


def device_ms(fn, rounds: int = 3, reps: int = 5) -> float:
    """Median device ms of one ``fn()``: ``rounds`` calls captured into one
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / rounds)
    return statistics.median(times)


def inputs(gen, B, S, dev):
    nc = S // C
    xbc = (torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev) * 0.5
           ).to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev)
                    ).reshape(B, nc, C, H)
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    return (xbc[..., :H * P].reshape(B, nc, C, H, P), dt,
            torch.cumsum(dt * A, dim=2),
            xbc[..., H * P:H * P + N].reshape(B, nc, C, N),
            xbc[..., H * P + N:].reshape(B, nc, C, N))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssd_ab.py: no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ssd_scan as k4

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"K4 bf16 from {args.src}, H={H} P={P} N={N} chunk {C}  [{smi}]")
    for B, S in SHAPES:
        x = inputs(gen, B, S, dev)
        want = k4.ssd_scan_plain(*x)[0].float()
        got = k4.ssd_scan(*x)[0].float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) \
                or bool((err > 2e-2 + 2e-2 * want.abs()).any()):
            sys.exit(f"B={B} S={S}: max abs err {float(err.max()):.3e} "
                     "exceeds 2e-2")
        print(f"B={B} S={S}: {device_ms(lambda: k4.ssd_scan(*x)):.4f} ms, "
              f"max abs err {float(err.max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
