"""Every engine on one model — counterpart of ``examples/quickstart.py``:
the conjugate Gaussian with observations (3, 4), exact posterior
N(2.32353, 1.05882) (reference README.md:118).

    python -m cpprob_tpu_torch.examples.quickstart [--quick] [--device cuda]
"""

import argparse


def report(name, mean, var, extra=""):
    print(f"{name:>14}: mean={float(mean):.4f} var={float(var):.4f} "
          f"(exact 2.3235 / 1.0588) {extra}")


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="quickstart")
    ap.add_argument("--quick", action="store_true", help="tiny sizes for CI smoke runs")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import gaussian_unknown_mean_readme as model

    from ..util.device import resolve_device

    dev = resolve_device(args.device)
    q = args.quick
    obs = (3.0, 4.0)
    out = {}

    res = ct.sis(model, obs, 5_000 if q else 100_000, 0, device=dev)
    report("SIS", res.mean("Mean"), res.variance("Mean"), f"ESS={float(res.ess):.0f}")
    out["SIS"] = float(res.mean("Mean"))

    eng = CSIS(model, (0.0, 0.0), device=dev)
    params, _ = eng.compile(1, steps=50 if q else 200, batch_size=64 if q else 256)
    res = eng.infer(params, obs, 5_000 if q else 100_000, 0)
    report("CSIS", res.mean("Mean"), res.variance("Mean"), f"ESS={float(res.ess):.0f}")
    out["CSIS"] = float(res.mean("Mean"))

    res = ct.smc_sampler(model, obs, 512 if q else 4096, 0, n_hmc_moves=3,
                         hmc_step_size=0.5, device=dev)
    mus = res.samples["mu"].double()
    report("temperedSMC", mus.mean(), mus.var(unbiased=False),
           f"logZ={float(res.log_evidence):.3f}")
    out["temperedSMC"] = float(mus.mean())

    res = ct.hmc(model, obs, 0, n_samples=300 if q else 1500, n_warmup=150 if q else 500,
                 n_chains=2 if q else 4, device=dev)
    mus = res.samples["mu"].reshape(-1).double()
    report("HMC", mus.mean(), mus.var(unbiased=False),
           f"accept={float(res.accept_rate.mean()):.2f}")
    out["HMC"] = float(mus.mean())

    res = ct.nuts(model, obs, 0, n_samples=200 if q else 1200, n_warmup=150 if q else 500,
                  n_chains=2 if q else 4, max_depth=6, device=dev)
    mus = res.samples["mu"].reshape(-1).double()
    report("NUTS", mus.mean(), mus.var(unbiased=False))
    out["NUTS"] = float(mus.mean())

    res = ct.svi(model, obs, 0, steps=300 if q else 1500, device=dev)
    mus = res.sample(9, 20_000)["mu"].double()
    report("SVI", mus.mean(), mus.var(unbiased=False))
    out["SVI"] = float(mus.mean())
    return out


if __name__ == "__main__":
    main()
