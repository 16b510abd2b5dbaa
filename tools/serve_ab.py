#!/usr/bin/env python3
"""Time the full-width gemma2-2b serve of one source tree, for A/B comparisons.

    python3 tools/serve_ab.py SRC_DIR [--reps 3]

``SRC_DIR`` is a directory that holds a ``repro_torch`` package (``src`` for
this checkout, or the ``src`` of another commit unpacked beside it).  Two
versions are compared inside ONE job on one card, in turns, because two jobs
may land on cards and hosts of different speed:

    for t in parent/src src src parent/src; do python3 tools/serve_ab.py $t; done

Each repetition serves the 8 requests of ``chip_smoke.py`` phase 5 (same
seeds, so the same tokens) and prints the wall time; the last one also times
every decode tick with a synchronise before and after.  Needs one CUDA device.
"""
import argparse
import statistics
import sys
import time

import numpy as np
import torch

PROMPT_LENS = [37, 128, 512, 1000, 2048, 5000, 64, 300]
NEW_TOKENS = 16


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="directory that holds the repro_torch package")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_ab.py: no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.core.jobgen import poisson_trace
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("gemma2-2b")
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))

    def requests():
        trace = poisson_trace(0.5, len(PROMPT_LENS), ["chat"], seed=0)
        rng = np.random.default_rng(0)
        return [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size, size=n,
                                            dtype=np.int64).astype(np.int32),
                        max_new_tokens=NEW_TOKENS, arrival_s=float(t) * 1e-6)
                for i, (n, t) in enumerate(zip(PROMPT_LENS, trace.arrival_us))]

    with torch.no_grad():                     # warm-up: build, library handles
        warm = torch.zeros((1, 64), dtype=torch.int64, device=dev)
        _, cache = model.prefill(params, {"tokens": warm}, 128)
        model.decode_step(params, cache, warm[:, :1], 64)
    torch.cuda.synchronize()

    name = torch.cuda.get_device_name(0)
    for rep in range(args.reps):
        eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=dev)
        ticks = []
        if rep == args.reps - 1:
            step = eng.step

            def timed_step():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                ticks.append(time.perf_counter() - t0)
            eng.step = timed_step
        reqs = requests()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        line = (f"{args.src} rep {rep}: wall {wall:.3f} s, {eng.ticks} ticks, "
                f"first tokens {[r.output[:3] for r in reqs[:2]]}")
        if ticks:
            line += f", tick median {1e3 * statistics.median(ticks):.2f} ms"
        print(f"{line}  [{name}]", flush=True)


if __name__ == "__main__":
    main()
