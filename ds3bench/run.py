"""Runs one cell of the benchmark once on the CUDA cards of this machine.

    python3 ds3bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and last ``checks``: each number compared with
its limit); the numbers compared are also the last lines of standard error.
Exits non-zero, printing no result, when there is no CUDA card or fewer
than the cell asks for, when the program (``src/repro_torch``) is absent,
and when a module of JAX or of the JAX package was loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def use_checkout_caches() -> None:
    """The program's build and kernel caches at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    # The client is one process on one host thread: an intra-op pool of a
    # thread a core waits at every parallel region for its slowest thread,
    # so a core that another tenant of the host holds stalls the call.
    torch.set_num_threads(1)
    from ds3bench.harness import spec
    bench = spec.read_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from ds3bench.harness.runner import run_cell
    return run_cell(ROOT, args.workload, args.seed, args.seconds,
                    bool(args.trace), device="cuda", t0=_T0)


if __name__ == "__main__":
    sys.exit(main())
