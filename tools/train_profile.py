#!/usr/bin/env python3
"""Where a training step's time goes on the card: ``torch.profiler`` over a
few steps of ``repro_torch.launch.steps.make_train_step`` as
``launch/train.py`` drives it (``train_config`` preset, under its
deterministic mode), after warm-up steps.

    python3 tools/train_profile.py [--arch mamba2-130m] [--preset full]
        [--batch 8] [--seq 256] [--steps 3] [--top 15]
        [--grad-only [--stages 4 --micro 4]]

Prints the median synchronised step (a host clock), the device time the
profiler saw a step (the sum of kernel times; busy share = that over the
step), the top operators by device time with their call counts, and the
device time under autograd's select backward (each repeat's slice of a
stacked parameter).  ``--grad-only`` profiles the loss and its gradient
alone, without the optimizer and its f32 state (for a model whose master
weights and moments do not fit the card beside it); with ``--stages`` the
GPipe schedule over a (stages, 1, 1) pod mesh with ``--micro``
microbatches.  Needs one CUDA device.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# lint: waive TX003 -- a program: set before torch's first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch.mesh import rules_for  # noqa: E402
from repro_torch.launch.steps import (batch_to, init_opt_state,  # noqa: E402
                                      make_train_step)
from repro_torch.launch.train import deterministic, train_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sharding import Mesh, use_mesh  # noqa: E402


def grad_step(model):
    """One loss and gradient, as ``make_train_step`` takes them, and no
    update: (params, opt, metrics) in, the same params and opt out."""
    def step(params, opt, batch):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = model.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        del grads
        return params, opt, {"loss": loss.detach()}
    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--preset", choices=["tiny", "full"], default="full")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--grad-only", action="store_true",
                    help="the loss and gradient alone, no optimizer state")
    ap.add_argument("--stages", type=int, default=0,
                    help="with --grad-only: GPipe stages (0: the plain stack)")
    ap.add_argument("--micro", type=int, default=4,
                    help="GPipe microbatches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_profile.py: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = train_config(args.arch, args.preset)
    if args.stages:
        cfg = cfg.replace(pipeline_stages=args.stages,
                          pipeline_microbatches=args.micro)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    if args.grad_only:
        opt, step = None, grad_step(model)
    else:
        opt, step = init_opt_state(params), make_train_step(model,
                                                            AdamWConfig())
    mesh = Mesh((max(args.stages, 1), 1, 1), ("pod", "data", "model"))
    pipe = SyntheticLMPipeline(cfg.vocab_size, args.batch, args.seq)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    times = []
    with deterministic(), use_mesh(mesh, rules_for(
            mesh, batch_size=args.batch, kind="train_pp")):
        for s in range(args.warmup):
            params, opt, _ = step(params, opt, pipe.batch_at(s))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for s in range(args.warmup, args.warmup + args.steps):
                t0 = time.perf_counter()
                params, opt, _ = step(params, opt, pipe.batch_at(s))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    what = ("loss+grad" if args.grad_only else "train step") + (
        f", GPipe {args.stages} stages x {args.micro} microbatches"
        if args.stages else "")
    print(f"[profile] {args.arch} {args.preset} ({cfg.num_layers} layers, "
          f"{cfg.dtype}, remat {cfg.remat}, {what}), B={args.batch} "
          f"S={args.seq}: "
          f"median step {ms:.2f} ms, device time {dev_ms:.2f} ms a step "
          f"(busy {dev_ms / ms * 100:.1f}%), {len(times)} steps profiled  "
          f"[{smi}]")
    ops = sorted((e for e in events if e.self_device_time_total > 0
                  and e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:args.top]:
        print(f"[profile]   {e.key:<48} {e.self_device_time_total / 1e3 / args.steps:9.3f} "
              f"ms a step, {e.count // args.steps:6d} calls a step")
    sel = [e for e in events if e.key == "aten::select_backward"]
    sel_ms = sum(e.device_time_total for e in sel) / 1e3 / args.steps
    print(f"[profile] under aten::select_backward (its fill and copy): "
          f"{sel_ms:.3f} ms a step, {sum(e.count for e in sel) // args.steps}"
          f" calls a step ({sel_ms / dev_ms * 100:.1f}% of the device time)")


if __name__ == "__main__":
    main()
