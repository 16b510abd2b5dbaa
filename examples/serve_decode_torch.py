"""Serving example on the PyTorch port: continuous batching with DS3 Poisson
arrivals.

The twin of ``examples/serve_decode.py``: a small gemma2-family model serves
a stream of requests generated by the paper's job generator
(``repro_torch.core.poisson_trace``) through ``repro_torch.serving``'s
engine, on the card's kernels by default (``--device cpu`` runs their plain
versions); reports per-request latency and engine throughput.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import poisson_trace
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch)).replace(window_size=32)
    model = build_model(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(model.device).manual_seed(0))
    engine = ServeEngine(model, params, num_slots=args.slots, max_len=128,
                         device=args.device)

    trace = poisson_trace(rate_jobs_per_ms=0.5, num_jobs=args.requests,
                          app_names=["chat"], seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=8,
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    arrival_s=float(t) * 1e-6)
            for i, t in enumerate(trace.arrival_us)]

    t0_s = time.time()
    engine.run(reqs)
    wall_s = time.time() - t0_s
    lats_s = [r.latency_s for r in reqs]
    toks = sum(len(r.output) for r in reqs)
    print(f"{len(reqs)} requests, {toks} tokens in {wall_s:.2f}s "
          f"({toks / wall_s:.1f} tok/s, {engine.ticks} decode ticks)")
    print(f"latency p50={np.percentile(lats_s, 50)*1e3:.0f}ms "
          f"p95={np.percentile(lats_s, 95)*1e3:.0f}ms")
    for r in reqs[:3]:
        print(f"  req{r.rid}: arrival={r.arrival_s*1e3:6.1f}ms "
              f"latency={r.latency_s*1e3:7.1f}ms out={r.output[:6]}...")


if __name__ == "__main__":
    main()
