"""How often PyTorch's first multi-threaded CPU ``exp`` of a process comes
back wrong, without the port imported and with it (``util/cpu_math.py``
makes that first call at the import; ROADMAP C4).

    python -m cpprob_tpu_torch.util.first_exp [--processes 100] [--jobs 6]

Each fresh process takes the exp of the same 262,144 values in float32 and
in float64 (the first dtype alternates between processes) and compares each
with numpy's float64 exp.  Prints one JSON line: the intra-op thread count,
and for each case and dtype the processes whose first call was that dtype,
how many of those calls and of the later ones were wrong, and the largest
relative error seen.  It runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["first_exp_errors", "main"]


# a fresh process: its first exp of one dtype, then of the other, each on
# 8 x 32,768 values against numpy's float64 exp; the port imported first
# or not at all
_CHILD = """
import json, numpy as np, torch
if {guard}:
    import cpprob_tpu_torch
a = np.random.default_rng({seed}).normal(0, 3.0, 8 * 32768)
a -= a.max()
out = {{}}
for name in {order}:
    x = a.astype(name)
    got = torch.exp(torch.as_tensor(x)).double().numpy()
    want = np.exp(x.astype(np.float64))
    out[name] = float((np.abs(got - want) / want).max())
print(json.dumps(out))
"""
# relative errors beyond these are wrong: 4 float32 ulp, ~450 float64 ulp
_WRONG = {"float32": 2.4e-7, "float64": 1e-13}


def first_exp_errors(guard: bool, seed: int) -> dict:
    """The largest relative error of each dtype's first ``exp`` in one
    fresh process (the first dtype alternates with the seed)."""
    order = ["float32", "float64"][::1 if seed % 2 else -1]
    root = Path(__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(
        guard=guard, seed=seed, order=order)], cwd=root, capture_output=True,
        text=True, timeout=300, check=True)
    return {"first": order[0], **json.loads(proc.stdout)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="first CPU exp calls that come back wrong")
    ap.add_argument("--processes", type=int, default=100)
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args(argv)
    out = {"threads": torch.get_num_threads()}
    for guard in (False, True):
        with ThreadPoolExecutor(args.jobs) as pool:
            runs = list(pool.map(lambda s: first_exp_errors(guard, s),
                                 range(args.processes)))
        res = {}
        for dt, tol in _WRONG.items():
            first = [r for r in runs if r["first"] == dt]
            res[dt] = {"first_calls": len(first),
                       "first_wrong": sum(r[dt] > tol for r in first),
                       "later_wrong": sum(r[dt] > tol for r in runs if r["first"] != dt),
                       "max_rel": max(r[dt] for r in runs)}
        out["port imported" if guard else "without the port"] = res
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
