"""The control of a cell's correctness check, on the card:

    python3 benchmarks/control.py --workload <name> --seeds <s1,s2,...> --queries <n>

For each seed, the plain reference computed in bfloat16 answers the
first ``--queries`` queries of a run with that seed, in the program's
place; prints one JSON line a seed with its numbers beside the cell's
limits and ``correct``, which has to read false.  The benchmark's runs do
not run it."""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--queries", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR.parent))

    import torch

    from harness import control, manifest

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.Manifest(BENCH_DIR.parent, BENCH_DIR).cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, checks = control.control(cell, seed, args.queries, torch.bfloat16,
                                          args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": correct, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
