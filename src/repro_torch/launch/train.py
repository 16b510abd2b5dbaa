"""End-to-end fault-tolerant training loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --preset tiny --steps 200 --batch 8 --seq 256 [--device cpu]

The twin of ``src/repro/launch/train.py``, on one device (``--device``,
default ``cuda``).  ``--production-mesh`` raises at once: the 256-device
mesh cannot run on one card (the reference's ``make_production_mesh`` fails
too without 256 devices).  ``pipeline_stages > 1`` needs a mesh with a
``pod`` axis installed (``sharding.use_mesh``), as in the reference.
Both presets train on ``attn_impl="blocked"``, the reference's default: the
port's CUDA kernels (``attn_impl="cuda"``) have no backward and refuse to
launch under grad.  ``tiny`` is the reduced config in f32 without remat;
``full`` the published widths in bf16 with ``remat="full"``.

Production behaviours (tested in tests/test_torch_train.py):
  * checkpoint/restart: atomic manifests, async save every --ckpt-every
    steps, resume from the latest checkpoint (``--resume``); a checkpoint
    holds ``{"params", "opt"}`` and the pipeline's state, in the reference's
    layout, so either package resumes the other's;
  * simulated preemption: ``--fail-at N`` raises mid-run; the retry loop
    restores and continues — final weights are bit-identical to an
    uninterrupted run (deterministic data addressing, and every step under
    ``torch.use_deterministic_algorithms(True)``: the card's atomics are
    unordered, so this mode is what makes the bits repeat there;
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` must be set before the process's
    first cuBLAS call, which ``train`` does when it is the first);
  * straggler watchdog: per-step wall times are tracked and steps slower
    than ``straggler_factor ×`` the running median are flagged;
  * gradient compression (``--compress-grads``) and microbatch accumulation
    (``--accum``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced
from ..data import SyntheticLMPipeline
from ..models import build_model
from ..optim import AdamWConfig
from .mesh import make_production_mesh
from .steps import init_opt_state, make_train_step


class StragglerWatchdog:
    """Flags steps whose wall time exceeds factor × running median."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times = []
        self.events = []

    def observe(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) > self.warmup:
            med = float(np.median(self.times[-50:]))
            if dt > self.factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                return True
        return False


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, then the
    caller's setting back.  An op with no deterministic form raises in it."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def train_config(arch: str, preset: str):
    """The model config a preset trains: ``tiny`` = reduced, f32, no remat;
    ``full`` = published widths, bf16, ``remat="full"``; both ``blocked``."""
    cfg = get_config(arch)
    if preset == "tiny":
        cfg = reduced(cfg)
    elif preset != "full":
        raise ValueError(f"preset={preset!r} (tiny, full)")
    cfg = cfg.replace(remat="none" if preset == "tiny" else "full",
                      attn_impl="blocked")
    if cfg.family in ("vlm", "audio") and preset != "tiny":
        raise ValueError("frontend stubs: the trainer takes LM families at "
                         "full scale")
    return cfg


def train(arch: str = "mamba2-130m", preset: str = "tiny", steps: int = 50,
          batch: int = 8, seq: int = 256, lr: float = 3e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          resume: bool = False, fail_at: Optional[int] = None,
          accum: int = 1, compress_grads: bool = False, seed: int = 0,
          log_every: int = 10, production_mesh: bool = False,
          device="cuda"):
    if production_mesh:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise ValueError(
            f"the production mesh has {make_production_mesh().size} devices; "
            f"this process has {n} CUDA device(s)")
    # read once, at the process's first cuBLAS call: set it before that
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(device)
    cfg = train_config(arch, preset)

    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(seed))
    opt_state = init_opt_state(params, compress_grads=compress_grads)
    pipe = SyntheticLMPipeline(cfg.vocab_size, batch, seq, seed=seed)
    step_fn = make_train_step(model, AdamWConfig(lr=lr), accum_steps=accum,
                              compress_grads=compress_grads)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        del params, opt_state                      # before the restored copy
        state, meta = mgr.restore(device=dev)
        params, opt_state = state["params"], state["opt"]
        pipe.load_state_dict(meta["data"])
        start = meta["step"]
        print(f"[train] resumed from step {start}")

    watchdog = StragglerWatchdog()
    losses = []
    try:
        with deterministic():
            for step in range(start, steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected preemption at step {step}")
                t0 = time.time()
                batch_np = pipe.batch_at(step)
                pipe.state.step = step + 1
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch_np)
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - t0
                if watchdog.observe(step, dt):
                    print(f"[train] straggler flagged at step {step}: "
                          f"{dt:.2f}s")
                if step % log_every == 0 or step == steps - 1:
                    toks = batch * seq / max(dt, 1e-9)
                    print(f"[train] step {step:5d} loss {loss:8.4f} "
                          f"gnorm {float(metrics['grad_norm']):7.3f} "
                          f"{dt*1e3:7.1f} ms/step {toks:9.0f} tok/s")
                if mgr and (step + 1) % ckpt_every == 0:
                    mgr.save(step + 1, {"params": params, "opt": opt_state},
                             meta={"data": pipe.state_dict()}, blocking=False)
        if mgr:
            mgr.save(steps, {"params": params, "opt": opt_state},
                     meta={"data": pipe.state_dict()})
    finally:
        if mgr:
            mgr.wait()          # a retry restores only what was committed
    return params, losses, watchdog


def train_with_retries(max_retries: int = 3, **kw):
    """The fleet-facing entry: restart-from-checkpoint on any failure (not
    on a missing device or an option the port does not have, which raise at
    once)."""
    resolve_device(kw.get("device", "cuda"))
    attempt = 0
    while True:
        try:
            return train(**kw)
        except NotImplementedError:
            raise
        except RuntimeError as e:
            attempt += 1
            print(f"[train] failure: {e}; retry {attempt}/{max_retries}")
            if attempt > max_retries:
                raise
            kw = dict(kw, resume=True, fail_at=None)


def main(argv=None):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    train_with_retries(
        arch=args.arch, preset=args.preset, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, fail_at=args.fail_at,
        accum=args.accum, compress_grads=args.compress_grads,
        production_mesh=args.production_mesh, device=args.device)


if __name__ == "__main__":
    main()
