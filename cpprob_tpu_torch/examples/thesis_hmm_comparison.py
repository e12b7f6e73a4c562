"""The thesis's headline accuracy experiment — counterpart of
``examples/thesis_hmm_comparison.py`` (doc/compiled_inference.pdf ch. 6.3,
figs. 6.6-6.7): CSIS vs SIS on the 3-state HMM, summed L2 and KL distance
of the per-step posterior marginals to the exact forward-backward
posterior, across particle counts 10^1..10^4.  Expected: CSIS ~1 order of
magnitude better at equal particle count.

    python -m cpprob_tpu_torch.examples.thesis_hmm_comparison [--length 16] [--quick]
"""

import argparse
import sys


def marginals(res, T):
    import numpy as np

    from ._common import to_np

    states = to_np(res.predicts["State"])  # (n, T)
    w = to_np(res.normalized_weights)
    out = np.zeros((T, 3))
    for t in range(T):
        for s in range(3):
            out[t, s] = float(np.sum(w * (states[:, t] == s)))
    return out


def distances(est, exact):
    import numpy as np

    l2 = float(np.sum((est - exact) ** 2))
    eps = 1e-12
    kl = float(np.sum(exact * (np.log(exact + eps) - np.log(est + eps))))
    return l2, kl


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="thesis_hmm_comparison")
    ap.add_argument("--length", type=int, default=16, help="HMM length (thesis uses 16)")
    ap.add_argument("--train-steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="tiny sizes for CI smoke runs")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.core import handlers
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import hmm, hmm_exact_posterior

    from ..util.device import resolve_device
    from ._common import to_np

    dev = resolve_device(args.device)
    T = args.length
    # observations simulated from the model prior (fixed seed)
    tr = handlers.TraceHandler()
    with handlers.Seed(torch.Generator(device=dev).manual_seed(99)), \
            handlers.SimulateObserves(), tr:
        hmm(torch.zeros(T, device=dev))
    obs = torch.stack([tr.trace[f"y[{t}]"]["value"] for t in range(T)])
    exact = np.asarray(hmm_exact_posterior(to_np(obs)))

    print(f"training CSIS proposal on the length-{T} HMM ...", file=sys.stderr)
    eng = CSIS(hmm, (torch.zeros(T, device=dev),), tie_addresses=True, device=dev)
    params, losses = eng.compile(args.seed, steps=60 if args.quick else args.train_steps,
                                 batch_size=64 if args.quick else 256, unroll=20)
    losses = to_np(losses)
    print(f"loss {losses[0]:.2f} -> {losses[-1]:.2f}", file=sys.stderr)

    print(f"{'n_particles':>12} {'SIS_L2':>10} {'CSIS_L2':>10} "
          f"{'SIS_KL':>10} {'CSIS_KL':>10} {'L2_ratio':>9}")
    rows = []
    for n in ([10, 100] if args.quick else [10, 100, 1000, 10_000]):
        res_sis = ct.sis(hmm, (obs,), n, args.seed + n, device=dev)
        res_csis = eng.infer(params, (obs,), n, args.seed + n)
        l2_s, kl_s = distances(marginals(res_sis, T), exact)
        l2_c, kl_c = distances(marginals(res_csis, T), exact)
        rows.append({"n_particles": n, "sis_l2": l2_s, "csis_l2": l2_c,
                     "sis_kl": kl_s, "csis_kl": kl_c})
        print(f"{n:>12} {l2_s:>10.4f} {l2_c:>10.4f} "
              f"{kl_s:>10.4f} {kl_c:>10.4f} {l2_s / max(l2_c, 1e-9):>9.1f}")
    return rows


if __name__ == "__main__":
    main()
