"""The readings a cell's limits are set from, in one process on the card.

    python3 ds3bench/readings.py --workload <name> --seeds 1,2,... \
        [--calls 2] [--control-seeds 1,2,3] [--out FILE]

For each seed: the cell's inputs, ``--calls`` calls of the program (the
cell's own sizes), and the seed's sample of lanes against the plain
reference, as a run checks them: the lower readings.  For each control
seed the same lanes with the reference computed in bfloat16 in the
program's place: the upper readings.  Prints one line a seed and, last,
the widest lower and the least upper reading of each number as JSON.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from ds3bench.run import use_checkout_caches
    use_checkout_caches()
    from ds3bench.harness import check, runner
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper, rows = {}, {}, []
    for seed in dict.fromkeys(seeds + controls):
        t = time.perf_counter()
        prep = runner.prepare(ROOT, args.workload, seed, "cuda")
        outs = []
        for _ in range(args.calls):
            outs += runner.timed_calls(prep, 0.0, "cuda", first=len(outs))[1]
        row = {"seed": seed, "failed": runner.non_finite(prep, outs)}
        if seed in seeds:
            row["program"] = check.widest(runner.sampled_gaps(prep, outs,
                                                              seed))
            for k, v in row["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in controls:
            row["control"] = check.widest(runner.sampled_gaps(
                prep, outs, seed, precision="bfloat16"))
            for k, v in row["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": seeds,
               "control_seeds": controls, "lower": lower, "upper": upper,
               "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("workload", "lower", "upper")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
