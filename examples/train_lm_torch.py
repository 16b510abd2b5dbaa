"""End-to-end training example on the PyTorch port.

The twin of ``examples/train_lm.py``, through ``repro_torch.launch.train``
on one device (``--device``, default cuda; cpu runs the same code on the
host).

Tiny preset (runs in about a minute on the CPU):
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Demonstrating fault tolerance (injected preemption + resume):
    PYTHONPATH=src python examples/train_lm_torch.py --demo-preemption

Published widths on one card (bf16, ``remat="full"``):
    PYTHONPATH=src python examples/train_lm_torch.py --arch gemma2-2b \
        --preset full --batch 4 --seq 256 --steps 20
"""
import argparse
import tempfile

from repro_torch.launch.train import train, train_with_retries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--demo-preemption", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    if args.demo_preemption:
        with tempfile.TemporaryDirectory() as d:
            print("== run with injected preemption at step 60; the retry "
                  "loop restores from the step-40 checkpoint ==")
            _, losses, wd = train_with_retries(
                arch=args.arch, preset=args.preset, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=d, ckpt_every=40,
                fail_at=60, device=args.device)
            print(f"final loss {losses[-1]:.4f}; "
                  f"straggler events: {len(wd.events)}")
        return

    _, losses, wd = train(arch=args.arch, preset=args.preset,
                          steps=args.steps, batch=args.batch, seq=args.seq,
                          device=args.device)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps; "
          f"straggler events: {len(wd.events)}")


if __name__ == "__main__":
    main()
