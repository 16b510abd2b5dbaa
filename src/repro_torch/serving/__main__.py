"""Serving example: continuous batching with DS3 Poisson arrivals.

A decoder-only model with random weights serves a stream of requests generated
by the paper's job generator; reports per-request latency and engine
throughput.  The twin of ``examples/serve_decode.py``.  The families it
serves: attention (gemma2-2b, granite-3-8b, mistral-nemo-12b, starcoder2-7b),
mixture-of-experts (deepseek-moe-16b, dbrx-132b), Mamba2 (mamba2-130m) and
Griffin (recurrentgemma-2b).

    python -m repro_torch.serving --arch gemma2-2b                # full width, on the GPU
    python -m repro_torch.serving --arch deepseek-moe-16b
    python -m repro_torch.serving --arch recurrentgemma-2b --reduced --device cpu

A mamba2 prompt's length must be a multiple of min(256, length), and an MoE
prompt's a multiple of min(moe_group_size, length) (2,048), as in the
reference (``ValueError``).  dbrx-132b at full width holds 263 GB of bf16
weights, more than one 80 GB card: serve it ``--reduced``.  paligemma-3b and seamless-m4t-large-v2 are not served here: the
engine admits a request with its tokens only, as the reference's does, and
these need patch embeddings or audio frames beside them (and seamless an
encoder length in its cache); drive them through ``Model.prefill`` /
``Model.decode_step`` (README.md).
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
    ap.add_argument("--arch", default="gemma2-2b",
                    help="gemma2-2b, granite-3-8b, mistral-nemo-12b, "
                         "starcoder2-7b, deepseek-moe-16b, dbrx-132b (an MoE "
                         "prompt's length a multiple of min(2048, length)), "
                         "mamba2-130m or recurrentgemma-2b "
                         "(paligemma-3b and seamless-m4t-large-v2 take "
                         "patch embeddings or frames the engine does not "
                         "admit: drive them through Model)")
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
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        ap.error(f"{args.arch} takes {cfg.frontend} inputs beside its tokens, "
                 "which the engine does not admit: drive it through "
                 "Model.prefill / Model.decode_step")
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
