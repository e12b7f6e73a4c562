"""Posterior-parser benchmark — counterpart of
``examples/posterior_parse_bench.py``: the native C++ parser against the
Python s-expression parser, measured through the public API
(``StatsPrinter.from_dump`` / ``load_posterior``) on a large
reference-format dump of an HMM posterior drawn on the device.  The parse
runs on the host, so the card only draws the posterior.

Prints the record as one JSON line; ``--out`` also writes it.

    python -m cpprob_tpu_torch.examples.posterior_parse_bench [--particles 786432]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="posterior_parse_bench")
    ap.add_argument("--particles", type=int, default=786_432)
    ap.add_argument("--length", type=int, default=16)
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.io import dump_posterior
    from cpprob_tpu_torch.io.serialization import load_posterior
    from cpprob_tpu_torch.io.tracefile import native_available
    from cpprob_tpu_torch.models import hmm
    from cpprob_tpu_torch.postprocess.stats import StatsPrinter

    from ..util.device import resolve_device

    dev = resolve_device(args.device)
    if not native_available():
        print("native library unavailable; nothing to benchmark", file=sys.stderr)
        return None

    obs = torch.randn(args.length, generator=torch.Generator().manual_seed(7)).to(dev)
    res = ct.sis(hmm, (obs,), args.particles, 0, device=dev,
                 batch_size=min(args.particles, 1 << 17))
    tmp = tempfile.mkdtemp(prefix="posterior_parse_bench")
    path = os.path.join(tmp, "posterior")
    try:
        t0 = time.perf_counter()
        dump_posterior(path, res)
        dump_s = time.perf_counter() - t0
        size = sum(os.path.getsize(path + ext) for ext in (".ids", ".int", ".real")
                   if os.path.exists(path + ext))
        print(f"dump: {args.particles} particles x {args.length} predicts = "
              f"{size / 1e6:.1f} MB in {dump_s:.1f}s", file=sys.stderr)

        def timed(native):
            t0 = time.perf_counter()
            predicts, log_w = load_posterior(path, native=native)
            return time.perf_counter() - t0, predicts, log_w

        t_native, pred_n, lw_n = timed(True)
        t_python, pred_p, lw_p = timed(False)
        np.testing.assert_allclose(lw_n, lw_p, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(pred_n["State"], np.float64),
                                   np.asarray(pred_p["State"], np.float64), rtol=1e-12)
        t0 = time.perf_counter()
        StatsPrinter.from_dump(path).summary()
        t_full = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "experiment": "posterior_parse_native_vs_python",
        "reference": "stats_printer.hpp:88-120 (StatsPrinter parse stage)",
        "device": str(dev),
        "dump_mb": size / 1e6,
        "n_particles": args.particles,
        "entries": args.particles * args.length,
        "load_posterior_native_s": t_native,
        "load_posterior_python_s": t_python,
        "speedup_public_api": t_python / t_native,
        "statsprinter_from_dump_s": t_full,
        "parity": "native and Python parses identical (asserted)",
    }
    print(f"load_posterior: native {t_native:.2f}s vs python {t_python:.2f}s "
          f"= {t_python / t_native:.1f}x; StatsPrinter.from_dump {t_full:.2f}s",
          file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
