"""The port's tempered SMC sampler, particle Gibbs and SMC²
(``cpprob_tpu_torch.inference.smc_sampler``, ``particle_gibbs``, ``smc2``)
against the JAX package's.

- Exact: the adaptive-tempering bisection on pinned log-likelihoods (the
  reference's ``next_beta``, nested in ``smc_sampler``, transcribed);
  ``_split_log_joint`` against the reference's and against the log-joint;
  ``SMC2Result``'s weights and ``mean`` on a θ population carried across
  by ``interop.theta_from_numpy``.
- Statistics, with ``tests/test_smc_sampler.py``'s,
  ``test_particle_gibbs.py``'s and ``test_smc2.py``'s tolerances: log Z
  against the analytic marginals and posterior moments at 2,048
  particles; the bimodal posterior keeps both modes; particle-Gibbs
  marginals against the exact forward-backward smoother; SMC² log Z
  against the quadrature over σ of the Kalman evidence at N_θ × N_x =
  128 × 128.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch
from scipy.special import betaln

import cpprob_tpu as jt
import cpprob_tpu.distributions as jd
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.distributions as pd
from cpprob_tpu_torch.distributions.base import HOST_READS
from cpprob_tpu_torch.inference.particle_gibbs import csmc_sweep, particle_gibbs
from cpprob_tpu_torch.inference.smc2 import ParamSSM, SMC2Result, smc2
from cpprob_tpu_torch.interop import theta_from_numpy
from cpprob_tpu_torch.models.hmm import hmm_exact_posterior, hmm_ssm

jsmc, jpot, jsmc2 = (importlib.import_module(f"cpprob_tpu.inference.{m}")
                     for m in ("smc_sampler", "potential", "smc2"))
psmc, ppot = (importlib.import_module(f"cpprob_tpu_torch.inference.{m}")
              for m in ("smc_sampler", "potential"))

torch.set_num_threads(2)

README_MEAN, README_VAR = 2.32353, 1.05882
DATA = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.int32)
HMM_OBS = np.array([0.9, -1.1, 0.2, 1.3, 0.8, -0.4, 1.0, -1.2, 0.1, 0.6], np.float32)


def _readme_log_z():
    cov = np.array([[4.0 + 2.25, 2.25], [2.25, 4.0 + 2.25]])
    return sps.multivariate_normal.logpdf([3.0, 4.0], [1.0, 1.0], cov)


def _models(ct, D, logaddexp):
    def beta_bernoulli(y):
        p = ct.sample(D.Beta(2.0, 2.0), addr="p")
        for i in range(y.shape[0]):
            ct.observe(D.Bernoulli(p), y[i], addr=f"y[{i}]")

    def bimodal():
        x = ct.sample(D.Normal(0.0, 10.0), addr="x")
        ct.factor(logaddexp(D.Normal(3.0, 0.5).log_prob(x), D.Normal(-3.0, 0.5).log_prob(x)),
                  addr="bimodal")

    def two_sites(y):
        s = ct.sample(D.Gamma(2.0, 1.0), addr="s")
        m = ct.sample(D.Normal(0.0, 2.0), addr="m")
        ct.observe(D.Normal(m, s), y[0], addr="y0")
        ct.observe(D.Normal(m, s), y[1], addr="y1")

    return {
        "readme": (ct.models.gaussian_unknown_mean_readme, (3.0, 4.0)),
        "beta_bernoulli": (beta_bernoulli, (DATA,)),
        "bimodal": (bimodal, ()),
        "two_sites": (two_sites, (np.array([1.5, -0.5], np.float32),)),
    }


JMODELS = _models(jt, jd, jnp.logaddexp)
PMODELS = _models(pt, pd, torch.logaddexp)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _reference_next_beta(beta, loglik, target_cess):
    """The reference's ``next_beta`` (``cpprob_tpu/inference/smc_sampler.py:
    151-169``), transcribed."""
    n = loglik.shape[0]

    def cess(b):
        lw = (b - beta) * loglik
        lw = lw - jnp.max(lw)
        w = jnp.exp(lw)
        return (jnp.sum(w) ** 2) / (n * jnp.sum(w * w))

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        return jax.lax.cond(cess(mid) >= target_cess, lambda: (mid, hi), lambda: (lo, mid))

    lo, _ = jax.lax.fori_loop(0, 20, body, (beta, jnp.float32(1.0)))
    return jnp.where(cess(1.0) >= target_cess, 1.0, lo)


@pytest.mark.parametrize("target", [0.9, 0.5])
def test_next_beta_matches_reference(target):
    rng = np.random.RandomState(0)
    for beta in (0.0, 0.05, 0.3, 0.97):
        for scale in (0.1, 3.0, 30.0):
            loglik = (-0.5 * (rng.randn(2048) * scale) ** 2 - 4.0).astype(np.float32)
            want = _reference_next_beta(jnp.float32(beta), jnp.asarray(loglik), target)
            got = psmc._next_beta(torch.tensor(beta, dtype=torch.float32),
                                  torch.as_tensor(loglik), target)
            _close(got, want, 1e-6, f"beta {beta}, scale {scale}")


@pytest.mark.parametrize("name", ["readme", "beta_bernoulli", "two_sites"])
def test_split_log_joint_matches_reference(name):
    model, args = JMODELS[name]
    jflat = jpot.flatten_model(model, args)
    j_prior, j_lik = jsmc._split_log_joint(model, args, jflat)
    model, args = PMODELS[name]
    pflat = ppot.flatten_model(model, args, device="cpu")
    p_prior, p_lik = psmc._split_log_joint(model, args, pflat)
    z = (np.random.RandomState(1).randn(16, jflat.dim) * 1.5).astype(np.float32)
    zt = torch.as_tensor(z)
    prior, lik = torch.func.vmap(p_prior)(zt), torch.func.vmap(p_lik)(zt)
    _close(prior, jax.vmap(j_prior)(z), 1e-5, "log prior")
    _close(lik, jax.vmap(j_lik)(z), 1e-5, "log likelihood")
    _close(prior + lik, torch.func.vmap(pflat.log_joint)(zt), 1e-5, "prior + likelihood")


@pytest.mark.parametrize("waste_free", [False, True])
def test_conjugate_gaussian_posterior_and_evidence(waste_free):
    model, args = PMODELS["readme"]
    before = HOST_READS["smc_sampler"]
    kw = dict(waste_free=True, chain_length=8) if waste_free else dict(n_hmc_moves=3)
    res = pt.smc_sampler(model, args, 2048, 0, hmc_step_size=0.5, device="cpu", **kw)
    mus = _np(res.samples["mu"])
    assert mus.shape == (2048,)
    assert abs(mus.mean() - README_MEAN) < 0.08
    assert abs(mus.var() - README_VAR) < 0.25
    assert abs(float(res.log_evidence) - _readme_log_z()) < (0.12 if waste_free else 0.1)
    assert int(res.n_stages) >= 1 and float(res.accept_rate) > 0.3
    # one host read a stage: the read after the last stage ends the loop
    assert HOST_READS["smc_sampler"] - before == int(res.n_stages)
    betas = _np(res.betas_used)
    assert betas[int(res.n_stages) - 1] == 1.0 and np.all(np.diff(betas) >= 0)


def test_bounded_support():
    model, args = PMODELS["beta_bernoulli"]
    res = pt.smc_sampler(model, args, 2048, 1, hmc_step_size=0.3, device="cpu")
    ps = _np(res.samples["p"])
    assert ps.min() > 0 and ps.max() < 1
    assert abs(ps.mean() - 10.0 / 14.0) < 0.03
    assert abs(float(res.log_evidence) - (betaln(2 + 8, 2 + 2) - betaln(2, 2))) < 0.1


def test_multimodal_survives_tempering():
    model, args = PMODELS["bimodal"]
    res = pt.smc_sampler(model, args, 4096, 2, n_hmc_moves=2, hmc_step_size=0.3, device="cpu")
    xs = _np(res.samples["x"])
    assert 0.25 < float((xs > 0).mean()) < 0.75
    assert abs(np.abs(xs).mean() - 3.0) < 0.3


def test_engines_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    model, args = PMODELS["readme"]
    T = HMM_OBS.shape[0]
    for call in (lambda: pt.smc_sampler(model, args, 64, 0),
                 lambda: csmc_sweep(hmm_ssm, HMM_OBS, 8, 0, np.zeros(T, np.int32)),
                 lambda: particle_gibbs(hmm_ssm, HMM_OBS, 8, 2, 0),
                 lambda: smc2(SMC2_MODEL, smc2_data(), 8, 8, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_waste_free_validation():
    model, args = PMODELS["readme"]
    with pytest.raises(ValueError, match="divisible"):
        pt.smc_sampler(model, args, 100, 0, waste_free=True, chain_length=8, device="cpu")
    with pytest.raises(ValueError, match="chain_length >= 2"):
        pt.smc_sampler(model, args, 128, 0, waste_free=True, chain_length=1, device="cpu")


# ---------------------------------------------------------------------------
# particle Gibbs


def test_csmc_sweep_shapes_and_reference_reachable():
    T = HMM_OBS.shape[0]
    res = csmc_sweep(hmm_ssm, HMM_OBS, 16, 0, np.zeros(T, np.int32), device="cpu")
    traj = _np(res.trajectory)
    assert traj.shape == (T,) and traj.min() >= 0 and traj.max() <= 2
    assert np.isfinite(float(res.log_evidence))
    # with N = 1 the only particle is the clamped reference: the identity kernel
    ref = np.array([0, 1, 2, 0, 1, 2, 0, 1, 2, 0], np.int32)
    res = csmc_sweep(hmm_ssm, HMM_OBS, 1, 0, ref, ancestor_sampling=False, device="cpu")
    np.testing.assert_array_equal(_np(res.trajectory), ref)


@pytest.mark.parametrize("ancestor_sampling", [True, False])
def test_particle_gibbs_matches_forward_backward(ancestor_sampling):
    """Two chains of the reference test's length, pooled: at 500 correlated
    draws one chain's largest marginal error is 0.026-0.087 over 12 seeds
    without ancestor sampling (the reference's own 0.036-0.074), around
    the 0.08 tolerance."""
    exact = hmm_exact_posterior(HMM_OBS)
    chains = []
    for seed in (0, 1):
        trajs, log_zs = particle_gibbs(hmm_ssm, HMM_OBS, 32, 600, seed, burn_in=100,
                                       ancestor_sampling=ancestor_sampling, device="cpu")
        assert trajs.shape == (500, HMM_OBS.shape[0]) and log_zs.shape == (500,)
        assert np.all(np.isfinite(_np(log_zs)))
        chains.append(_np(trajs))
    trajs = np.concatenate(chains)
    emp = np.stack([(trajs == k).mean(0) for k in range(3)], 1)
    np.testing.assert_allclose(emp, exact, atol=0.08)


# ---------------------------------------------------------------------------
# SMC²


def _kalman_ll(observations, r):
    """Exact log-evidence of the unit random-walk SSM with obs variance r."""
    m_pred, p_pred, ll = 0.0, 1.0, 0.0
    for y in observations:
        s = p_pred + r
        ll += sps.norm.logpdf(y, m_pred, np.sqrt(s))
        k = p_pred / s
        m_pred = m_pred + k * (y - m_pred)
        p_pred = (1.0 - k) * p_pred + 1.0
    return ll


def smc2_data():
    """tests/test_smc2.py's data: T = 25, true σ = 1.5."""
    rng = np.random.RandomState(0)
    x, ys = 0.0, []
    for _ in range(25):
        x = rng.normal(x, 1.0)
        ys.append(rng.normal(x, 1.5))
    return np.asarray(ys, np.float32)


def smc2_quadrature_log_z(ys):
    """log ∫ p(y | σ) p(σ) dσ over the log-σ prior N(0, 0.5)."""
    grid = np.linspace(-1.6, 1.6, 81)
    lp = np.array([_kalman_ll(ys, float(np.exp(g)) ** 2) + sps.norm.logpdf(g, 0, 0.5)
                   for g in grid])
    return np.log(np.trapezoid(np.exp(lp - lp.max()), dx=grid[1] - grid[0])) + lp.max()


def _randn(g):
    return torch.randn((), generator=g, device=g.device)


SMC2_MODEL = ParamSSM(
    prior_sample=lambda g: {"log_sigma": 0.5 * _randn(g)},
    prior_logpdf=lambda th: pd.Normal(0.0, 0.5, device=th["log_sigma"].device).log_prob(
        th["log_sigma"]),
    init_sample=lambda g, th: _randn(g),
    step_sample=lambda g, x, t, th: x + _randn(g),
    obs_logpdf=lambda x, y, t, th: pd.Normal(x, torch.exp(th["log_sigma"])).log_prob(y),
)


def test_smc2_evidence_and_parameter():
    ys = smc2_data()
    before = HOST_READS["smc2"]
    res = smc2(SMC2_MODEL, ys, 128, 128, 0, device="cpu")
    assert HOST_READS["smc2"] - before == len(ys) - 1      # one a step
    assert abs(float(res.log_evidence) - smc2_quadrature_log_z(ys)) < 0.8
    assert abs(float(res.mean(lambda th: torch.exp(th["log_sigma"]))) - 1.5) < 0.45
    assert bool(res.rejuvenations.any()) and not bool(res.rejuvenations[0])
    assert float(res.accept_rate) > 0.05
    assert np.all(np.isfinite(_np(res.log_weights)))


def test_smc2_result_on_carried_thetas():
    rng = np.random.RandomState(2)
    thetas = {"log_sigma": rng.randn(64).astype(np.float32) * 0.5,
              "rho": rng.rand(64, 2).astype(np.float32)}
    lw = (rng.randn(64) * 3).astype(np.float32)
    jres = jsmc2.SMC2Result(jax.tree_util.tree_map(jnp.asarray, thetas), jnp.asarray(lw),
                            jnp.zeros(()), jnp.zeros(3, bool), jnp.zeros(()))
    pres = SMC2Result(theta_from_numpy(thetas, device="cpu"), torch.as_tensor(lw),
                      torch.zeros(()), torch.zeros(3, dtype=torch.bool), torch.zeros(()))
    _close(pres.normalized_weights, jres.normalized_weights, 1e-6, "weights")
    _close(pres.mean(lambda th: torch.exp(th["log_sigma"])),
           jres.mean(lambda th: jnp.exp(th["log_sigma"])), 1e-6, "mean of sigma")
    _close(pres.mean(lambda th: th["rho"] * th["log_sigma"]),
           jres.mean(lambda th: th["rho"] * th["log_sigma"]), 1e-6, "mean of a vector")


@pytest.mark.cuda
def test_smc_engines_on_the_card_without_sync():
    """The tempered sampler, particle Gibbs and SMC² queue their work
    without a sync; the counted reads (one a stage, one a step) are the
    only ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, args = PMODELS["readme"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = pt.smc_sampler(model, args, 1 << 14, 0)
        trajs, _ = particle_gibbs(hmm_ssm, HMM_OBS, 256, 20, 0)
        r = smc2(SMC2_MODEL, smc2_data(), 64, 64, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert s.positions.device.type == trajs.device.type == r.log_weights.device.type == "cuda"
    assert torch.isfinite(s.log_evidence) and torch.isfinite(r.log_evidence)
