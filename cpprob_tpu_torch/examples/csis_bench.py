"""CSIS evidence record — counterpart of ``examples/csis_bench.py``.

The thesis experiment (doc/compiled_inference.pdf ch. 6.3, figs.
6.6-6.7): CSIS vs SIS on the 3-state length-16 HMM, summed L2 and KL
distance of per-step posterior marginals to the exact forward-backward
posterior, across particle counts 10^1..10^4.  Also the compile (training)
throughput in traces/s (``infcomp/logger.py:127-135``) and the serving
number: guided-inference throughput of ``CSIS.infer``.  Every timed region
ends with a host copy of a result.  The reference's fallbacks to the CPU
and its scanned serving loop (both for a remote TPU runtime) have no
counterpart: a failure raises.

Prints the record as one JSON line; ``--out`` also writes it.

    python -m cpprob_tpu_torch.examples.csis_bench [--seeds 5] [--device cuda]
"""

import argparse
import json
import sys
import time

GUIDED_PARTICLES = 65536  # population of the timed guided-inference calls
GUIDED_STEPS = 200        # training steps of the unrolled engine that is served


def distances(est, exact):
    import numpy as np

    l2 = float(np.sum((est - exact) ** 2))
    eps = 1e-12
    kl = float(np.sum(exact * (np.log(exact + eps) - np.log(est + eps))))
    return l2, kl


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="csis_bench")
    ap.add_argument("--length", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=1500)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=5,
                    help="independent inference repetitions per particle count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.core import handlers
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import hmm, hmm_exact_posterior, hmm_scan
    from cpprob_tpu_torch.util.profiling import env_versions

    from ..util.device import resolve_device
    from ._common import sync, to_np

    dev = resolve_device(args.device)
    T = args.length
    # observations simulated from the model prior (fixed seed)
    tr = handlers.TraceHandler()
    with handlers.Seed(torch.Generator(device=dev).manual_seed(99)), \
            handlers.SimulateObserves(), tr:
        hmm(torch.zeros(T, device=dev))
    obs = torch.stack([tr.trace[f"y[{t}]"]["value"] for t in range(T)])
    exact = np.asarray(hmm_exact_posterior(to_np(obs)))

    # compile (training) with measured traces/s; the warm-up steps are
    # outside the timed region
    eng = CSIS(hmm_scan, (torch.zeros(T, device=dev),), tie_addresses=True, device=dev)
    t_setup = time.perf_counter()
    params, warm = eng.compile(args.seed, steps=26, batch_size=args.batch_size, unroll=25)
    to_np(warm)
    compile_wall = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    params, losses = eng.compile(args.seed + 1, steps=args.train_steps,
                                 batch_size=args.batch_size, params=params, unroll=25)
    losses = to_np(losses)  # the host copy closes the timed region
    train_wall = time.perf_counter() - t0
    traces_per_sec = args.train_steps * args.batch_size / train_wall
    print(f"train: {args.train_steps} steps x batch {args.batch_size} in "
          f"{train_wall:.2f}s = {traces_per_sec:,.0f} traces/s (warm-up {compile_wall:.1f}s)",
          file=sys.stderr)

    # accuracy: one N=10^4 run per (method, seed); the n < 10^4 estimators
    # come from partitioning the particles into N/n independent groups
    N = 10_000
    grid = [10, 100, 1000, 10_000]
    acc = {n: {"sis_l2": [], "csis_l2": [], "sis_kl": [], "csis_kl": []} for n in grid}

    def group_errors(res, n):
        states = to_np(res.predicts["State"])          # (N, T)
        log_w = to_np(res.log_weights).astype(np.float64)
        g = N // n
        states = states[: g * n].reshape(g, n, T)
        lw = log_w[: g * n].reshape(g, n)
        w = np.exp(lw - lw.max(axis=1, keepdims=True))
        w /= w.sum(axis=1, keepdims=True)
        l2s, kls = [], []
        for i in range(g):
            est = np.stack([(w[i][:, None] * (states[i] == s)).sum(0) for s in range(3)],
                           axis=1)
            a, b = distances(est, exact)
            l2s.append(a)
            kls.append(b)
        return float(np.mean(l2s)), float(np.mean(kls))

    for rep in range(args.seeds):
        seed = args.seed + 1000 * rep + 17
        res_sis = ct.sis(hmm_scan, (obs,), N, seed, device=dev)
        res_csis = eng.infer(params, (obs,), N, seed)
        for n in grid:
            a, b = group_errors(res_sis, n)
            c, d = group_errors(res_csis, n)
            acc[n]["sis_l2"].append(a)
            acc[n]["sis_kl"].append(b)
            acc[n]["csis_l2"].append(c)
            acc[n]["csis_kl"].append(d)

    rows = []
    print(f"{'n_particles':>12} {'SIS_L2':>10} {'CSIS_L2':>10} "
          f"{'SIS_KL':>10} {'CSIS_KL':>10} {'L2_ratio':>9} {'KL_ratio':>9}")
    for n in grid:
        row = {"n_particles": n, "n_seeds": args.seeds, "groups_per_seed": N // n}
        for k, v in acc[n].items():
            row[k] = float(np.mean(v))
        row["l2_ratio"] = row["sis_l2"] / max(row["csis_l2"], 1e-12)
        row["kl_ratio"] = row["sis_kl"] / max(row["csis_kl"], 1e-12)
        rows.append(row)
        print(f"{n:>12} {row['sis_l2']:>10.4f} {row['csis_l2']:>10.4f} "
              f"{row['sis_kl']:>10.4f} {row['csis_kl']:>10.4f} "
              f"{row['l2_ratio']:>9.1f} {row['kl_ratio']:>9.1f}")

    # serving: guided inference on the unrolled per-site engine
    eng_u = CSIS(hmm, (torch.zeros(T, device=dev),), device=dev)
    params_u, _ = eng_u.compile(args.seed + 5, steps=GUIDED_STEPS,
                                batch_size=args.batch_size)
    n_inf = GUIDED_PARTICLES
    sync(dev)
    t0 = time.perf_counter()
    to_np(eng_u.infer(params_u, (obs,), n_inf, 98).log_weights)
    first_s = time.perf_counter() - t0
    ts = []
    for i in range(5):
        t0 = time.perf_counter()
        to_np(eng_u.infer(params_u, (obs,), n_inf, 1000 + i).log_weights)
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    guided_infer = {
        "n_particles": n_inf,
        "median_s": dt,
        "per_call_times_s": [round(t, 4) for t in ts],
        "guided_traces_per_sec": n_inf / dt,
        "first_call_s": first_s,
        "device": str(dev),
        "engine": "unrolled per-site",
    }
    print(f"guided inference: {n_inf} particles in {dt * 1e3:.1f} ms = "
          f"{n_inf / dt:,.0f} guided traces/s", file=sys.stderr)

    out = {
        "versions": env_versions(),
        "experiment": "thesis_hmm_csis_vs_sis",
        "reference": "doc/compiled_inference.pdf ch. 6.3 figs. 6.6-6.7 "
                     "(CSIS ~10x lower sum-L2/sum-KL than SIS, 10^1..10^4 "
                     "particles); traces/s format infcomp/logger.py:127-135",
        "device": str(dev),
        "T": T,
        "train": {
            "steps": args.train_steps,
            "batch_size": args.batch_size,
            "wall_s": train_wall,
            "traces_per_sec_steady_state": traces_per_sec,
            "warmup_compile_s": compile_wall,
            "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
        },
        "accuracy": rows,
        "sweep_device": {"sis": str(dev), "csis": str(dev)},
        "guided_infer": guided_infer,
        "errors": [],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
