"""One run of one cell of the benchmark of ``cpprob_tpu_torch`` on an
NVIDIA card.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes the
cell's observation series from ``--seed``, builds the port's SMC entry
(``build_smc_run``), warms it up, then for ``--seconds`` runs closed-loop
queries, one in flight, each ending when its log-evidence is back on the
host.  With ``--trace 1`` it profiles a slice of the window and reports
the per-layer metrics instead of the end-to-end ones.  After the window
it checks every answer against the plain reference.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``: each number compared beside its limit); the checks also
close standard error.  Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / "out" / "cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the kernel caches stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from harness import check, device, manifest, runner

    cell = manifest.Manifest(ROOT, BENCH_DIR).cell(args.workload)

    import torch

    print(f"setup: torch imported {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)     # one process, one host thread of CPU work
    name_power = device.gpu_name_and_power()
    result, checks, _ = runner.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t_start=T_START,
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    result["device"]["power_limit"] = device.power_limit(name_power)
    result["checks"] = result.pop("checks")
    for line in check.lines(checks):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
