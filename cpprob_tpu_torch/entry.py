"""The port's twins of ``__graft_entry__.py``: ``entry()``, one
guided-CSIS importance-sampling sweep on the HMM (T = 8, 128 particles
under ``torch.func.vmap``, the LSTM proposal network inside the particle
program), from the network of seed 0; and ``dryrun_multichip(n)``, the
multi-device paths and their gates, run in every rank of a process group.

    fn, args = entry()
    log_w, states = fn(*args)      # (128,), (128, 8)
"""

from __future__ import annotations

import torch

from .inference.csis import CSIS
from .inference.sis import _generator, _vmapped, make_particle_fn
from .models import hmm

__all__ = ["entry", "dryrun_multichip"]

T = 8
N_PARTICLES = 128


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(seed) -> (log_w (128,), State (128,
    8))`` on ``device`` (default ``"cuda"``; with no card it raises)."""
    obs = torch.zeros((T,), device=device)
    engine = CSIS(hmm, (obs,), device=device)
    params = engine.init(0)
    factory = engine.proposal_factory(params, (obs,))
    particle = make_particle_fn(hmm, (obs,), proposal_messenger=factory)

    def fn(seed):
        with torch.no_grad():
            log_w, predicts = _vmapped(particle, _generator(seed, device), N_PARTICLES)
        return log_w, predicts["State"]

    return fn, (1,)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The gates of ``__graft_entry__.dryrun_multichip`` over an
    ``n_devices``-rank particle mesh; every rank of an initialized process
    group (:func:`~cpprob_tpu_torch.parallel.initialize_multihost`, world
    size ``n_devices``) calls it.  Each estimator runs at 4 seeds and is
    held to its exact oracle within 4 standard errors of the seed mean
    plus 0.02:

    1. ``smc_sharded`` on the linear-Gaussian model (T = 16), ``collective``
       against the Kalman evidence; ``balanced`` equal to ``collective``
       bit for bit (evidence and final population); ``chunk=4`` with
       ``balanced`` on :func:`~cpprob_tpu_torch.ops.fused_lg.make_fused_lg_ssm`
       (the K7 kernel on each CUDA rank, its plain version on CPU ranks);
    2. ``island`` and ``exchange`` on the HMM (resampling every step)
       against the forward recursion and against each other;
    3. ``sis_sharded`` against the analytic conjugate posterior;
    4. one data-parallel ``CSIS.compile`` step on the HMM with a finite
       loss, the same on every rank.

    Raises ``AssertionError`` on a failed gate; returns the numbers."""
    import numpy as np

    from .models import (
        gaussian_posterior_analytic,
        gaussian_unknown_mean,
        hmm_log_evidence,
        hmm_ssm,
        kalman_filter_1d,
        linear_gaussian_ssm,
    )
    from .ops.fused_lg import make_fused_lg_ssm
    from .parallel import particle_mesh, sis_sharded, smc_sharded
    from .parallel._collectives import pmax, psum
    from .parallel.mesh import rank_device

    mesh = particle_mesh(n_devices, device=device)
    dev = rank_device(mesh)
    seeds, floor = 4, 0.02

    def seed_stats(fn, base):
        vals = np.array([fn(base + i) for i in range(seeds)])
        return float(vals.mean()), float(vals.std(ddof=1) / np.sqrt(seeds))

    def lz(model, obs, n, seed, **kw):
        return float(smc_sharded(model, obs, n, seed, mesh=mesh, **kw).log_evidence)

    # (1) the linear-Gaussian model, exact evidence by the Kalman filter
    ys = np.random.RandomState(3).normal(0.0, 1.1, size=16).astype(np.float32)
    obs_lg = torch.as_tensor(ys).to(dev)
    ll = float(kalman_filter_1d(ys)[2])
    n_lg = 1024 * n_devices
    mean_c, se_c = seed_stats(lambda s: lz(linear_gaussian_ssm, obs_lg, n_lg, s,
                                           scheme="collective"), 0)
    tol_c = 4 * se_c + floor
    assert abs(mean_c - ll) < tol_c, ("collective", mean_c, ll, tol_c)
    ring = smc_sharded(linear_gaussian_ssm, obs_lg, n_lg, 0, mesh=mesh, scheme="collective")
    bal = smc_sharded(linear_gaussian_ssm, obs_lg, n_lg, 0, mesh=mesh, scheme="balanced")
    assert float(bal.log_evidence) == float(ring.log_evidence), (
        "balanced != collective", float(bal.log_evidence), float(ring.log_evidence))
    assert torch.equal(bal.final_states, ring.final_states), "balanced != collective states"
    assert bool(ring.resampled.any()), "no resample epoch"
    fused = make_fused_lg_ssm()
    mean_ch, se_ch = seed_stats(lambda s: lz(fused, obs_lg, n_lg, s, scheme="balanced",
                                             chunk=4), 300)
    tol_ch = 4 * se_ch + floor
    assert abs(mean_ch - ll) < tol_ch, ("chunked balanced", mean_ch, ll, tol_ch)

    # (2) island and exchange on the HMM, resampling at every step
    obs_np = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    obs_hmm = torch.as_tensor(obs_np).to(dev)
    exact_hmm = float(hmm_log_evidence(obs_np))
    n_hmm = 512 * n_devices
    mean_i, se_i = seed_stats(lambda s: lz(hmm_ssm, obs_hmm, n_hmm, s, scheme="island",
                                           ess_threshold=1.0), 100)
    mean_e, se_e = seed_stats(lambda s: lz(hmm_ssm, obs_hmm, n_hmm, s, scheme="exchange",
                                           ess_threshold=1.0), 200)
    tol_e = 4 * se_e + floor
    assert abs(mean_e - exact_hmm) < tol_e, ("exchange", mean_e, exact_hmm, tol_e)
    tol_i = 4 * se_i + 2 * floor      # island: unbiased in Z, a Jensen gap in log Z
    assert abs(mean_i - exact_hmm) < tol_i, ("island", mean_i, exact_hmm, tol_i)
    tol_ie = 4 * float(np.hypot(se_i, se_e)) + 2 * floor
    assert abs(mean_i - mean_e) < tol_ie, ("island vs exchange", mean_i, mean_e, tol_ie)

    # (3) sharded SIS against the conjugate posterior
    res = sis_sharded(gaussian_unknown_mean, (3.0, 4.0), 4096 * n_devices, 2, mesh=mesh)
    mean_t, var_t = gaussian_posterior_analytic([3.0, 4.0])
    mu = float(res.mean("Mu"))
    tol_m = 4 * float(np.sqrt(var_t / float(res.ess))) + 0.005
    assert abs(mu - float(mean_t)) < tol_m, ("sis", mu, float(mean_t), tol_m)

    # (4) one data-parallel CSIS training step on the HMM
    engine = CSIS(hmm, (torch.zeros((8,), device=dev),), device=dev)
    _, losses = engine.compile(4, steps=1, batch_size=32 * n_devices, mesh=mesh)
    loss = losses[0].reshape(1)
    spread = pmax(loss, mesh) + pmax(-loss, mesh)
    assert bool(torch.isfinite(loss).all()), ("csis loss", float(loss))
    assert float(spread) == 0.0, ("csis loss differs across ranks", float(spread))
    # every rank reached the end
    assert int(psum(torch.ones(1, device=dev), mesh)) == n_devices

    out = {"kalman": ll, "collective": mean_c, "tol_collective": tol_c,
           "balanced_eq_collective": float(bal.log_evidence),
           "chunked_balanced": mean_ch, "tol_chunked": tol_ch, "exact_hmm": exact_hmm,
           "island": mean_i, "exchange": mean_e, "sis_mu": mu, "sis_exact": float(mean_t),
           "tol_sis": tol_m, "csis_loss": float(loss)}
    print(f"dryrun_multichip({n_devices}): smc collective logZ={mean_c:.3f} (kalman "
          f"{ll:.3f}, 4se+floor {tol_c:.3f}), balanced==ring bitwise "
          f"({float(bal.log_evidence):.3f}), chunked+balanced logZ={mean_ch:.3f} (tol "
          f"{tol_ch:.3f}), island logZ={mean_i:.3f}, exchange logZ={mean_e:.3f} (exact "
          f"{exact_hmm:.3f}), sis mu={mu:.4f} (exact {float(mean_t):.4f}, tol {tol_m:.4f}), "
          f"csis dp loss={float(loss):.3f}")
    return out
