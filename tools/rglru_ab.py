#!/usr/bin/env python3
"""Time the RG-LRU recurrence (K5) of one source tree, for A/B comparisons.

    python3 tools/rglru_ab.py [SRC_DIR]

At recurrentgemma-2b's width (W=2560, f32, a = sigmoid(r) and x / 2 as
``chip_smoke.py`` makes them) over S = 37 ... 8192 and batches of 1, 2 and 4,
checks ``rg_lru`` against its plain version (1e-5) and prints its device time
per call (CUDA-graph replay of three calls on the same inputs, CUDA events,
median of 5; a replay may find inputs smaller than the 50 MB L2 there) beside
the byte bound (a and x read and h written once at 3.35 TB/s) and beside the
time of ``torch.add(a, x)``, which moves the same bytes (a yardstick of what an
elementwise kernel reaches on the card, not the same function).  ``SRC_DIR``
(default: this checkout's ``src``) may be the ``src`` of another commit
unpacked beside it.  Two versions are compared inside ONE job on one card,
in turns:

    for t in parent/src src src parent/src; do python3 tools/rglru_ab.py $t; done

Needs one CUDA device.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
W = 2560
SHAPES = [(B, S) for B in (1, 2, 4) for S in (37, 256, 1000, 2048, 5000, 8192)]
PEAK_BYTES_S = 3.35e12      # H100 SXM data sheet
TOL = 1e-5


def device_ms(fn, rounds: int = 3, reps: int = 5) -> float:
    """Median device ms of one ``fn()``: ``rounds`` calls captured into one
    CUDA graph, replayed ``reps`` times between CUDA events.  The warm-up runs
    on the capturing stream, so what a wrapper makes once per stream is made
    outside the graph."""
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rglru_ab.py: no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import rg_lru as k5

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"K5 f32 from {args.src}, W={W}  [{smi}]")
    for B, S in SHAPES:
        a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev))
        x = torch.randn((B, S, W), generator=gen, device=dev) * 0.5
        want = k5.rg_lru_plain(a, x)
        got = k5.rg_lru(a, x)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) \
                or bool((err > TOL + TOL * want.abs()).any()):
            sys.exit(f"B={B} S={S}: max abs err {float(err.max()):.3e} "
                     f"exceeds {TOL}")
        ms = device_ms(lambda: k5.rg_lru(a, x))
        same_bytes = device_ms(lambda: torch.add(a, x))
        bound = 1e3 * 12 * B * S * W / PEAK_BYTES_S
        print(f"B={B} S={S}: {ms:.4f} ms, bound {bound:.5f} ms "
              f"({100 * bound / ms:.0f}%), torch.add of a and x (the same "
              f"bytes) {same_bytes:.4f} ms, max abs err "
              f"{float(err.max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
