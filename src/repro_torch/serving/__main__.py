"""Serving example: continuous batching with DS3 Poisson arrivals.

A gemma2-family model with random weights serves a stream of requests
generated by the paper's job generator; reports per-request latency and engine
throughput.  The twin of ``examples/serve_decode.py``.

    python -m repro_torch.serving --arch gemma2-2b                # full width, on the GPU
    python -m repro_torch.serving --arch gemma2-2b --reduced --device cpu
"""
import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduced
from ..core import poisson_trace
from ..models import build_model
from . import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (float32, window 32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="cuda", choices=["cuda", "einsum"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg).replace(window_size=32)
    cfg = cfg.replace(attn_impl=args.attn_impl)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init_params(gen)
    engine = ServeEngine(model, params, num_slots=args.slots,
                         max_len=args.max_len, device=args.device)

    trace = poisson_trace(rate_jobs_per_ms=0.5, num_jobs=args.requests,
                          app_names=["chat"], seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    arrival_s=float(t) * 1e-6)
            for i, t in enumerate(trace.arrival_us)]

    t0 = time.perf_counter()
    engine.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.perf_counter() - t0
    lats = [r.latency_s for r in reqs]
    toks = sum(len(r.output) for r in reqs)
    where = torch.cuda.get_device_name(model.device) \
        if model.device.type == "cuda" else "cpu"
    print(f"{cfg.name} on {where}: {len(reqs)} requests, {toks} tokens in "
          f"{wall:.2f}s ({toks / wall:.1f} tok/s, {engine.ticks} decode ticks)")
    print(f"latency p50={np.percentile(lats, 50)*1e3:.0f}ms "
          f"p95={np.percentile(lats, 95)*1e3:.0f}ms")
    for r in reqs[:3]:
        print(f"  req{r.rid}: arrival={r.arrival_s*1e3:6.1f}ms "
              f"latency={r.latency_s*1e3:7.1f}ms out={r.output[:6]}...")


if __name__ == "__main__":
    main()
