"""Whole sweeps of the paths the benchmark has no cell for, and the init
kernels, timed back to back on the card, for comparing two checkouts of
the port in one call.

    PYTHONPATH=CHECKOUT python3 cpprob_tpu_torch/util/sweep_times.py

The package is imported by absolute name, so ``PYTHONPATH`` picks the
checkout whose code runs (this file may come from another).  Sweeps, each
by CUDA events over back-to-back sweeps after a warm-up (``time_ms``): the
HMM per step at 2^20 (chunk 1: K4; ``smc()`` with history: K5), a 5-state
chain at 2^24 (chunk 8: K9, K8) and the same chain guided by a random
``[7,16,16,5]`` net at 2^24 (chunk 8: K13) and per step at 2^20 (K13
one-step), the linear-Gaussian physics as a user ``step_elem`` at 2^24
(chunk 8: K10 and the streaming epoch), and the guided linear-Gaussian
model with a random ``[3,16,16,2]`` net at 2^24 (chunk 8, ``mxu=True``:
K12's tensor-core twin; ``mxu=False``: K12 on the FMA pipe).  The HMM
main path and the linear-Gaussian model at chunk 8 and per step are the
benchmark's cells (``python3 benchmarks/run.py``).
The chain is the K-state recipe of tests/test_tpu_hw.py at K = 5 with
standard normal observations from ``default_rng(0)``.  Launches of the
init kernel alone: the HMM's (K1, 2^26) and the chain's (K9, K = 5, 2^24);
the streaming epoch alone at 2^24 (K14, K15, K16, on ``2 randn``
weights) and its stats alone (K14).
Prints one JSON line: the card and the ms of each.  It needs the card.
"""

import json
import sys

import numpy as np
import torch

HALF_LOG_2PI = 0.9189385332046727


def lg_step_elem(x, y, eps):
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - HALF_LOG_2PI


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_times times the card: no CUDA device")
    from cpprob_tpu_torch import build_smc_run, smc
    from cpprob_tpu_torch.inference.nn import mlp_init
    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.models import HMM_MEANS, HMM_TRANS, simulate_observations
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.ops.fused_hmm import hmm_init, make_fused_hmm_ssm
    from cpprob_tpu_torch.models.linear_gaussian import (
        linear_gaussian_ssm,
        obs_logpdf_elem,
        trans_logpdf_elem,
    )
    from cpprob_tpu_torch.models.linear_gaussian import (
        simulate_observations as lg_observations,
    )
    from cpprob_tpu_torch.ops.fused_ssm import (
        attach_fused_guided_discrete_kernels,
        attach_fused_guided_scalar_kernels,
        attach_fused_scalar_kernels,
        make_fused_discrete_ssm,
    )
    from cpprob_tpu_torch.util.profiling import gpu_name_and_power
    from cpprob_tpu_torch.util.roofline import time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    chain5 = (rng.dirichlet(np.ones(5), size=5), np.linspace(-3.0, 3.0, 5),
              np.linspace(0.5, 1.6, 5), np.full(5, 0.2))
    obs = torch.as_tensor(simulate_observations(16, 0), device=dev)
    obs5 = torch.as_tensor(np.random.default_rng(0).standard_normal(16)
                           .astype(np.float32), device=dev)
    gen = torch.Generator()
    gen.manual_seed(5)
    guided5 = attach_fused_guided_discrete_kernels(
        *chain5, params=mlp_init([7, 16, 16, 5], gen), T=16)
    hmm = make_fused_hmm_ssm()
    lg_obs = torch.as_tensor(lg_observations(16, 0), device=dev)
    net = mlp_init([3, 16, 16, 2], gen, device=dev)
    guided_lg = {mxu: attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, net, 16, trans_logpdf_elem=trans_logpdf_elem,
        obs_logpdf_elem=obs_logpdf_elem, mxu=mxu) for mxu in (True, False)}
    spec3 = spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))
    spec5 = spec_from_numpy(*chain5)
    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(5)
    lw = 2 * torch.randn(1 << 24, generator=gen_d, device=dev)
    vals = torch.randn(1 << 24, generator=gen_d, device=dev)
    runs = {
        "hmm_2^20_chunk1": (build_smc_run(hmm, 1 << 20), obs, 8),
        "hmm_2^20_smc": (lambda seed, o: smc(hmm, o, 1 << 20, seed), obs, 8),
        "chain5_2^24_chunk8": (build_smc_run(
            make_fused_discrete_ssm(*chain5), 1 << 24, chunk=8), obs5, 16),
        "guided5_2^24_chunk8": (build_smc_run(guided5, 1 << 24, chunk=8), obs5, 16),
        "guided5_2^20_chunk1": (build_smc_run(guided5, 1 << 20), obs5, 8),
        "user_lg_2^24_chunk8": (build_smc_run(attach_fused_scalar_kernels(
            linear_gaussian_ssm, lg_step_elem), 1 << 24, chunk=8), lg_obs, 16),
        **{f"guided_lg_2^24_chunk8_mxu_{mxu}": (build_smc_run(model, 1 << 24, chunk=8),
                                               lg_obs, 16)
           for mxu, model in guided_lg.items()},
        "hmm_init_2^26": (lambda seed, o: hmm_init(seed, o[0], 1 << 26, spec3), obs, 20),
        "chain5_init_2^24": (lambda seed, o: hmm_init(seed, o[0], 1 << 24, spec5), obs5, 20),
        "epoch_2^24": (lambda seed, o: sr.streaming_systematic_resample_values(
            gen_d, lw, vals), obs, 20),
        "lse_stats_2^24": (lambda seed, o: sr.logsumexp_stats(lw), obs, 20),
    }
    ms = {name: time_ms(lambda: run(20_000, o), reps)
          for name, (run, o, reps) in runs.items()}
    out = {"card": gpu_name_and_power(),
           "package": sys.modules["cpprob_tpu_torch"].__file__, "ms": ms}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
