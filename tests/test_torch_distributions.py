"""The port's distribution layer (``cpprob_tpu_torch.distributions``) and
its support transforms (``cpprob_tpu_torch.inference.transforms``) against
the JAX package's, on the same numpy inputs.

``log_prob``, ``cdf``, ``icdf``, ``mean`` and ``variance`` are held element
by element at the tolerances of ``tests/test_distributions.py`` (1e-5, and
1e-4 where that file uses it); the port's own ``betainc`` (torch has none)
to scipy's at 1e-6.  The draws differ from JAX's (another generator), so
the samplers are held statistically: moments within 5 SE of the analytic
ones at 2^16 draws, and a two-sample KS test against the JAX class's own
draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps_special
import scipy.stats as sps
import torch

from cpprob_tpu import distributions as jd
from cpprob_tpu.distributions.flow import _rqs as j_rqs
from cpprob_tpu.distributions.flow import _spline_params as j_spline_params
from cpprob_tpu.inference import transforms as jt
from cpprob_tpu_torch import distributions as pd
from cpprob_tpu_torch.distributions.continuous import betainc
from cpprob_tpu_torch.distributions.flow import _rqs as p_rqs
from cpprob_tpu_torch.distributions.flow import _spline_params as p_spline_params
from cpprob_tpu_torch.inference import transforms as pt

torch.set_num_threads(2)

N = 1 << 16
F32 = np.float32


def _both(name, *args):
    """The port's and the JAX package's ``name`` on the same numpy
    parameters (the port's on the CPU, from CPU tensors)."""
    args = [np.asarray(a, F32) for a in args]
    return (getattr(pd, name)(*[torch.as_tensor(a) for a in args]),
            getattr(jd, name)(*[jnp.asarray(a) for a in args]))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# (class, parameters, points, tolerance): the grids of
# tests/test_distributions.py, and beyond them the support's edges
CASES = {
    "normal": ("Normal", (np.array([-2.0, 0.0, 3.5])[:, None], np.array([0.5, 1.0, 7.2])[:, None]),
               np.linspace(-10, 10, 41), 1e-5),
    "normal_sigma0": ("Normal", (2.0, 0.0), np.array([1.0, 2.0, 3.0]), 1e-5),
    "uniform": ("Uniform", (2.0, 9.5), np.array([1.9, 2.0, 5.0, 9.5, 9.6]), 1e-5),
    "uniform_degenerate": ("Uniform", (3.0, 3.0), np.array([2.0, 3.0, 4.0]), 1e-5),
    "beta": ("Beta", (2.0, 3.0), np.concatenate([[-0.5, 0.0], np.linspace(0.01, 0.99, 21),
                                                   [1.0, 1.5]]), 1e-4),
    "beta_small": ("Beta", (0.5, 0.7), np.linspace(0.01, 0.99, 21), 1e-4),
    "gamma": ("Gamma", (2.0, 1.5), np.concatenate([[-1.0, 0.0], np.linspace(0.1, 20, 21)]), 1e-4),
    "laplace": ("Laplace", (0.5, 2.0), np.linspace(-5, 5, 21), 1e-5),
    "exponential": ("Exponential", (1.7,), np.concatenate([[-1.0], np.linspace(0.0, 10, 21)]),
                    1e-4),
    "lognormal": ("LogNormal", (0.5, 0.8), np.concatenate([[-1.0, 0.0], np.linspace(0.05, 10, 21)]),
                  1e-4),
    "halfnormal": ("HalfNormal", (2.0,), np.concatenate([[-1.0], np.linspace(0.0, 8, 17)]), 1e-5),
    "student_t": ("StudentT", (5.0, 1.0, 2.0), np.linspace(-8, 10, 25), 1e-4),
    "cauchy": ("Cauchy", (0.5, 1.5), np.linspace(-10, 10, 25), 1e-5),
    "min_max_continuous": ("MinMaxContinuous", (0.0, 10.0, 3.0, 6.0), np.linspace(0.5, 9.5, 19),
                           1e-4),
    "poisson": ("Poisson", (np.array([0.8, 3.0, 20.0])[:, None],), np.arange(-1, 40), 1e-4),
    "bernoulli": ("Bernoulli", (0.3,), np.array([0, 1]), 1e-5),
    "uniform_int": ("UniformInt", (2, 7), np.arange(0, 10), 1e-5),
    "categorical": ("Categorical", (np.array([0.2, 0.3, 0.5]) * 4.0,), np.arange(-1, 5), 1e-5),
}


def _case(key):
    name, params, xs, tol = CASES[key]
    if name in ("UniformInt",):
        p = (torch.as_tensor(params[0]), torch.as_tensor(params[1]))
        return pd.UniformInt(*p), jd.UniformInt(*params), xs, tol
    port, ref = _both(name, *params)
    return port, ref, xs, tol


@pytest.mark.parametrize("key", sorted(CASES))
def test_log_prob_matches_jax(key):
    port, ref, xs, tol = _case(key)
    x = xs.astype(np.int64 if port.is_discrete else F32)
    got = port.log_prob(torch.as_tensor(x))
    want = ref.log_prob(jnp.asarray(x))
    _close(got, want, tol)
    # the same infinities (out of support), in the same places
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(np.asarray(want)))


@pytest.mark.parametrize("key", sorted(k for k in CASES if hasattr(getattr(pd, CASES[k][0]), "cdf")
                                       and CASES[k][0] not in ("StudentT", "MinMaxContinuous",
                                                               "Poisson", "Bernoulli",
                                                               "UniformInt", "Categorical")))
def test_cdf_matches_jax(key):
    port, ref, xs, tol = _case(key)
    x = xs.astype(F32)
    _close(port.cdf(torch.as_tensor(x)), ref.cdf(jnp.asarray(x)), tol)


@pytest.mark.parametrize("key", ["normal", "normal_sigma0", "uniform", "cauchy"])
def test_icdf_matches_jax(key):
    port, ref, _, tol = _case(key)
    u = np.linspace(0.01, 0.99, 33).astype(F32)
    _close(port.icdf(torch.as_tensor(u)), ref.icdf(jnp.asarray(u)), max(tol, 1e-4))


@pytest.mark.parametrize("key", sorted(k for k in CASES if CASES[k][0] not in ("Cauchy",)))
def test_moments_match_jax(key):
    port, ref, _, tol = _case(key)
    _close(port.mean, ref.mean, 1e-5)
    if CASES[key][0] != "MinMaxContinuous":
        _close(port.variance, ref.variance, 1e-5)


def test_student_t_moments_undefined_below_their_order():
    for df in (0.8, 1.5, 3.0):
        port, ref = _both("StudentT", df, 1.0, 2.0)
        _close(port.mean, ref.mean, 1e-6)
        _close(port.variance, ref.variance, 1e-6)


def test_multivariate_normals_match_jax():
    loc = np.array([1.0, 2.0, 3.0], F32)
    scale = np.array([2.0, 1.0, 5.0], F32)
    x = np.random.default_rng(0).normal(0, 2, (7, 3)).astype(F32)
    port = pd.MultivariateNormalDiag(torch.as_tensor(loc), torch.as_tensor(scale))
    ref = jd.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale))
    _close(port.log_prob(torch.as_tensor(x)), ref.log_prob(jnp.asarray(x)), 1e-4)
    _close(port.variance, ref.variance, 1e-6)
    assert port.event_shape == ref.event_shape == (3,) and port.batch_shape == ()
    cov = np.array([[2.0, 0.8], [0.8, 1.0]], F32)
    loc2 = np.array([1.0, -1.0], F32)
    port = pd.MultivariateNormalFull.from_covariance(loc2, cov, device="cpu")
    ref = jd.MultivariateNormalFull.from_covariance(loc2, cov)
    x2 = np.random.default_rng(1).normal(0, 1, (5, 2)).astype(F32)
    # the reference solves for one point at a time (its triangular solve
    # takes no batch of points against one factor)
    _close(port.log_prob(torch.as_tensor(x2)), jax.vmap(ref.log_prob)(jnp.asarray(x2)), 1e-5)
    _close(port.log_prob(torch.as_tensor(x2[0])), sps.multivariate_normal.logpdf(x2[0], loc2, cov),
           1e-5)
    _close(port.variance, ref.variance, 1e-6)
    _close(port.scale_tril, ref.scale_tril, 1e-6)


def test_compound_log_prob_and_cdf_match_jax():
    locs, scales, w = (np.array(v, F32) for v in ([-1.0, 2.0], [0.5, 1.5], [0.3, 0.7]))
    mix_p = pd.Mixture(pd.Normal(torch.as_tensor(locs), torch.as_tensor(scales)),
                       torch.as_tensor(w))
    mix_j = jd.Mixture(jd.Normal(jnp.asarray(locs), jnp.asarray(scales)), jnp.asarray(w))
    x = np.linspace(-4, 6, 21).astype(F32)
    _close(mix_p.log_prob(torch.as_tensor(x)), mix_j.log_prob(jnp.asarray(x)), 1e-4)
    _close(mix_p.cdf(torch.as_tensor(x)), mix_j.cdf(jnp.asarray(x)), 1e-5)
    _close(mix_p.mean, mix_j.mean, 1e-6)
    # truncated normal: inside against JAX and scipy, -inf outside
    tr_p = pd.Truncated(pd.Normal(0.5, 2.0, device="cpu"), -1.0, 3.0)
    tr_j = jd.Truncated(jd.Normal(0.5, 2.0), -1.0, 3.0)
    xt = np.linspace(-2, 4, 25).astype(F32)
    got = tr_p.log_prob(torch.as_tensor(xt)).numpy()
    inside = (xt >= -1) & (xt <= 3)
    _close(got, tr_j.log_prob(jnp.asarray(xt)), 1e-4)
    _close(got[inside], sps.truncnorm.logpdf(xt, -0.75, 1.25, loc=0.5, scale=2.0)[inside], 1e-4)
    assert np.all(np.isneginf(got[~inside]))
    _close(tr_p.cdf(torch.as_tensor(xt)), tr_j.cdf(jnp.asarray(xt)), 1e-5)
    # a truncated mixture (no icdf) and a discrete base
    trm_p = pd.Truncated(mix_p, 0.0, 3.0)
    trm_j = jd.Truncated(mix_j, 0.0, 3.0)
    _close(trm_p.log_prob(torch.as_tensor(x)), trm_j.log_prob(jnp.asarray(x)), 1e-4)
    # MinMaxDiscrete, Dirac, ABC
    mmd_p = pd.MinMaxDiscrete(3, torch.tensor([1.0, 2.0, 1.0]))
    mmd_j = jd.MinMaxDiscrete(3, jnp.array([1.0, 2.0, 1.0]))
    k = np.array([3, 4, 5, 6, 2])
    _close(mmd_p.log_prob(torch.as_tensor(k)), mmd_j.log_prob(jnp.asarray(k)), 1e-5)
    _close(mmd_p.mean, mmd_j.mean, 1e-6)
    _close(mmd_p.variance, mmd_j.variance, 1e-6)
    dirac = pd.Dirac(2.5, device="cpu")
    assert float(dirac.log_prob(2.5)) == 0.0 and math.isinf(float(dirac.log_prob(2.6)))
    vec = pd.Dirac(torch.tensor([1.0, 2.0]))
    lp = vec.log_prob(torch.tensor([[1.0, 2.0], [1.0, 3.0]]))
    assert lp.shape == (2,) and float(lp[0]) == 0.0 and math.isinf(float(lp[1]))
    abc = pd.make_abc(lambda g: torch.randn((), generator=g), lambda x: -torch.abs(x))
    _close(abc.log_prob(torch.tensor(3.0)), -3.0, 1e-6)
    draws = abc.sample(torch.Generator().manual_seed(0), (4, 2))
    assert draws.shape == (4, 2) and len(set(draws.flatten().tolist())) == 8


def test_defensive_mixture_matches_jax_and_bounds_the_weights():
    prop_p, anchor_p = pd.Normal(2.0, 0.05, device="cpu"), pd.Uniform(0.0, 4.0, device="cpu")
    dm_p = pd.DefensiveMixture(prop_p, anchor_p, 0.25)
    dm_j = jd.DefensiveMixture(jd.Normal(2.0, 0.05), jd.Uniform(0.0, 4.0), 0.25)
    xs = np.linspace(0.1, 3.9, 64).astype(F32)
    got = dm_p.log_prob(torch.as_tensor(xs))
    _close(got, dm_j.log_prob(jnp.asarray(xs)), 1e-5)
    ratio = np.exp(anchor_p.log_prob(torch.as_tensor(xs)).numpy() - got.numpy())
    assert ratio.max() <= 1.0 / 0.25 + 1e-3
    # each draw is wholly one component, also with event dims
    dm = pd.DefensiveMixture(pd.MultivariateNormalDiag(torch.zeros(3), torch.full((3,), 0.1)),
                             pd.MultivariateNormalDiag(torch.full((3,), 5.0),
                                                       torch.full((3,), 0.1)), 0.5)
    x = dm.sample(torch.Generator().manual_seed(3), (512,)).numpy()
    near0, near5 = (np.abs(x) < 1.0).all(1), (np.abs(x - 5.0) < 1.0).all(1)
    assert x.shape == (512, 3) and np.all(near0 | near5) and 0.4 < near5.mean() < 0.6
    x = dm_p.sample(torch.Generator().manual_seed(4), (20_000,)).numpy()
    # three quarters of the mass is a tight spike at 2, a quarter uniform on
    # [0, 4] (a tenth of it within 0.2 of 2)
    frac_spike = np.mean(np.abs(x - 2.0) < 0.2)
    assert 0.74 < frac_spike < 0.81 and x.min() < 0.5 and x.max() > 3.5


# ---------------------------------------------------------------------------
# betainc, which torch lacks


def test_betainc_matches_scipy_and_jax():
    """The port's continued fraction against scipy's ``betainc`` at 1e-6 on
    a grid of (a, b, x) with a, b below 1 and above 50, in float64 and in
    float32, and against JAX's (float32) at 1e-5 where a, b <= 20."""
    ab = np.array([0.1, 0.5, 0.9, 1.0, 2.5, 7.0, 20.0, 60.0, 150.0, 400.0])
    x = np.concatenate([[0.0, 1e-6, 0.001], np.linspace(0.01, 0.99, 33), [0.999, 1.0]])
    a, b, xx = (g.ravel() for g in np.meshgrid(ab, ab, x, indexing="ij"))
    want = sps_special.betainc(a, b, xx)
    got = betainc(*(torch.as_tensor(v) for v in (a, b, xx)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got32 = betainc(*(torch.as_tensor(v, dtype=torch.float32) for v in (a, b, xx)))
    assert got32.dtype == torch.float32
    want32 = sps_special.betainc(*(v.astype(F32).astype(np.float64) for v in (a, b, xx)))
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-6, atol=1e-6)
    small = (a <= 20) & (b <= 20)
    want_j = np.asarray(jax.scipy.special.betainc(*(jnp.asarray(v[small], F32)
                                                     for v in (a, b, xx))))
    np.testing.assert_allclose(got32.numpy()[small], want_j, rtol=1e-5, atol=1e-5)
    # outside the domain: NaN, as scipy's
    bad = betainc(torch.tensor([-1.0, 2.0, 2.0]), torch.tensor([2.0, 0.0, 2.0]),
                  torch.tensor([0.5, 0.5, 1.5]))
    assert torch.isnan(bad).all()


def test_beta_cdf_at_the_support_edges():
    """Beta.cdf outside, at and inside [0, 1] against scipy at 1e-6, at a,
    b > 50, where the reference's float32 continued fraction is itself
    ~2e-5 from scipy's value: the port is held to the reference there by
    that distance."""
    port, ref = _both("Beta", 60.0, 75.0)
    x = np.array([-0.5, 0.0, 0.3, 0.44, 0.5, 0.7, 1.0, 1.5], F32)
    exact = sps.beta.cdf(np.clip(x, 0, 1), 60.0, 75.0)
    got = port.cdf(torch.as_tensor(x)).numpy()
    _close(got, exact, 1e-6)
    ref_err = np.abs(np.asarray(ref.cdf(jnp.asarray(x))) - exact)
    assert np.all(np.abs(got - np.asarray(ref.cdf(jnp.asarray(x)))) <= ref_err + 1e-6)


# ---------------------------------------------------------------------------
# samplers: moments within 5 SE of the analytic values, and a two-sample KS
# test against the JAX class's draws


SAMPLERS = {
    "normal": ("Normal", (2.0, 3.0)),
    "uniform": ("Uniform", (2.0, 9.5)),
    "beta": ("Beta", (2.0, 3.0)),
    "beta_small": ("Beta", (0.5, 0.7)),
    "gamma": ("Gamma", (2.0, 1.5)),
    "gamma_small": ("Gamma", (0.4, 1.0)),
    "laplace": ("Laplace", (1.0, 2.0)),
    "exponential": ("Exponential", (1.7,)),
    "lognormal": ("LogNormal", (0.5, 0.8)),
    "halfnormal": ("HalfNormal", (2.0,)),
    "student_t": ("StudentT", (5.0, 1.0, 2.0)),
    "cauchy": ("Cauchy", (0.5, 1.5)),
    "min_max_continuous": ("MinMaxContinuous", (0.0, 10.0, 3.0, 6.0)),
    "poisson": ("Poisson", (4.2,)),
    "bernoulli": ("Bernoulli", (0.3,)),
    "categorical": ("Categorical", (np.array([0.2, 0.3, 0.5]),)),
}


def _moments_within(x, mean, var, what):
    x = np.asarray(x, np.float64)
    n = len(x)
    se_mean = math.sqrt(var / n)
    assert abs(x.mean() - mean) < 5 * se_mean, f"{what}: mean {x.mean()} vs {mean}"
    dev2 = (x - x.mean()) ** 2
    se_var = math.sqrt(dev2.var() / n)
    assert abs(dev2.mean() - var) < 5 * se_var, f"{what}: variance {dev2.mean()} vs {var}"


def _analytic(name, params):
    if name == "MinMaxContinuous":   # no variance in the reference: a scaled beta's
        lo, hi, mode, k = params
        m01 = (mode - lo) / (hi - lo)
        a, b = m01 * (k - 2) + 1, (1 - m01) * (k - 2) + 1
        return (lo + (hi - lo) * a / (a + b),
                (hi - lo) ** 2 * a * b / ((a + b) ** 2 * (a + b + 1)))
    ref = getattr(jd, name)(*params)
    return float(ref.mean), float(ref.variance)


@pytest.mark.parametrize("key", sorted(SAMPLERS))
def test_sampler_matches_jax_in_distribution(key):
    name, params = SAMPLERS[key]
    port, ref = _both(name, *params)
    gen = torch.Generator().manual_seed(17)
    x = port.sample(gen, (N,))
    assert x.shape == (N,)
    assert x.dtype == (torch.int64 if port.is_discrete else torch.float32)
    x = x.numpy()
    y = np.asarray(ref.sample(jax.random.key(5), (N,)))
    if name != "Cauchy":
        _moments_within(x, *_analytic(name, params), key)
    ks = sps.ks_2samp(x, y)
    assert ks.pvalue > 1e-3, f"{key}: KS p {ks.pvalue}"


def test_discrete_samplers_match_their_pmf():
    """UniformInt and MinMaxDiscrete draws: each value's frequency within 5
    SE of its probability, and nothing outside the support."""
    gen = torch.Generator().manual_seed(2)
    x = pd.UniformInt(2, 7, device="cpu").sample(gen, (N,)).numpy()
    _moments_within(x, 4.5, 35 / 12, "uniform_int")
    counts = np.bincount(x, minlength=10)
    assert counts[:2].sum() == 0 and counts[8:].sum() == 0
    se = math.sqrt(N * (1 / 6) * (5 / 6))
    assert np.all(np.abs(counts[2:8] - N / 6) < 5 * se)
    x = pd.MinMaxDiscrete(3, torch.tensor([1.0, 2.0, 1.0])).sample(gen, (N,)).numpy()
    counts = np.bincount(x, minlength=7)
    p = np.array([0, 0, 0, 0.25, 0.5, 0.25, 0])
    assert np.all(np.abs(counts - N * p) < 5 * np.sqrt(N * p * (1 - p)) + 1e-9)


def test_mvn_samplers_match_their_moments():
    gen = torch.Generator().manual_seed(8)
    x = pd.MultivariateNormalDiag(torch.tensor([1.0, 2.0]), torch.tensor([2.0, 0.5])).sample(
        gen, (N,)).numpy()
    assert x.shape == (N, 2)
    _moments_within(x[:, 0], 1.0, 4.0, "mvn diag 0")
    _moments_within(x[:, 1], 2.0, 0.25, "mvn diag 1")
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    x = pd.MultivariateNormalFull.from_covariance([1.0, -1.0], cov, device="cpu").sample(
        gen, (N,)).numpy()
    _moments_within(x[:, 0], 1.0, 2.0, "mvn full 0")
    _moments_within(x[:, 1], -1.0, 1.0, "mvn full 1")
    _moments_within(x[:, 0] + x[:, 1], 0.0, 2.0 + 1.0 + 1.6, "mvn full sum")


def test_mixture_and_truncated_samplers():
    gen = torch.Generator().manual_seed(6)
    comp = pd.Normal(torch.tensor([-1.0, 2.0]), torch.tensor([0.5, 1.5]))
    mix = pd.Mixture(comp, torch.tensor([0.3, 0.7]))
    mean = 0.3 * -1.0 + 0.7 * 2.0
    ex2 = 0.3 * (0.25 + 1.0) + 0.7 * (2.25 + 4.0)
    x = mix.sample(gen, (N,)).numpy()
    _moments_within(x, mean, ex2 - mean ** 2, "mixture")
    y = np.asarray(jd.Mixture(jd.Normal(jnp.array([-1.0, 2.0]), jnp.array([0.5, 1.5])),
                              jnp.array([0.3, 0.7])).sample(jax.random.key(1), (N,)))
    assert sps.ks_2samp(x, y).pvalue > 1e-3
    assert mix.sample(gen).shape == ()
    # by the inverse CDF: inside the bounds, the truncated normal's law
    tr = pd.Truncated(pd.Normal(0.0, 1.0, device="cpu"), -1.0, 2.0)
    x = tr.sample(gen, (N,)).numpy()
    assert x.min() >= -1.0 and x.max() <= 2.0
    _moments_within(x, sps.truncnorm.mean(-1.0, 2.0), sps.truncnorm.var(-1.0, 2.0), "truncated")
    assert sps.kstest(x, sps.truncnorm(-1.0, 2.0).cdf).pvalue > 1e-3
    # by rejection (a mixture has no icdf): the truncated mixture's law
    trm = pd.Truncated(mix, 0.0, 3.0)
    x = trm.sample(gen, (N,)).numpy()
    assert x.min() >= 0.0 and x.max() <= 3.0
    y = np.asarray(jax.vmap(jd.Truncated(jd.Mixture(
        jd.Normal(jnp.array([-1.0, 2.0]), jnp.array([0.5, 1.5])), jnp.array([0.3, 0.7])),
        0.0, 3.0).sample)(jax.random.split(jax.random.key(2), N)))
    assert sps.ks_2samp(x, y).pvalue > 1e-3
    tc = pd.Truncated(pd.Cauchy(0.0, 1.0, device="cpu"), -2.0, 5.0).sample(gen, (N,))
    assert float(tc.min()) >= -2.0 and float(tc.max()) <= 5.0


# ---------------------------------------------------------------------------
# the spline flow


K = 8


def _flows(seed, batch=(), loc=0.7, scale=1.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=batch + (K,)).astype(F32)
    h = rng.normal(size=batch + (K,)).astype(F32)
    d = (0.5 * rng.normal(size=batch + (K - 1,))).astype(F32)
    lo, sc = np.full(batch, loc, F32), np.full(batch, scale, F32)
    port = pd.SplineFlow1D(*(torch.as_tensor(v) for v in (w, h, d, lo, sc)))
    ref = jd.SplineFlow1D(*(jnp.asarray(v) for v in (w, h, d, lo, sc)))
    return port, ref


def test_spline_flow_log_prob_matches_jax():
    port, ref = _flows(0)
    xs = np.linspace(-12, 12, 301).astype(F32)
    _close(port.log_prob(torch.as_tensor(xs)), ref.log_prob(jnp.asarray(xs)), 1e-5)
    pb, rb = _flows(1, (32,))
    xb = np.linspace(-9, 9, 32).astype(F32)
    _close(pb.log_prob(torch.as_tensor(xb)), rb.log_prob(jnp.asarray(xb)), 1e-5)
    assert pb.batch_shape == tuple(rb.batch_shape) == (32,)
    assert pb.sample(torch.Generator().manual_seed(0)).shape == (32,)


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_transform_matches_jax(inverse):
    port, ref = _flows(11)
    xs_p = p_spline_params(port.w_logits, port.h_logits, port.d_raw, port.bound)
    xs_j = j_spline_params(ref.w_logits, ref.h_logits, ref.d_raw, ref.bound)
    for a, b in zip(xs_p, xs_j):
        _close(a, b, 1e-6)
    z = np.linspace(-6.0, 6.0, 201).astype(F32)
    out_p, ld_p = p_rqs(torch.as_tensor(z), *xs_p, inverse=inverse)
    out_j, ld_j = j_rqs(jnp.asarray(z), *xs_j, inverse=inverse)
    _close(out_p, out_j, 1e-5)
    _close(ld_p, ld_j, 1e-5)


def test_spline_flow_is_invertible_and_normalised():
    port, _ = _flows(11)
    xs_, ys_, ds_ = p_spline_params(port.w_logits, port.h_logits, port.d_raw, port.bound)
    z = torch.linspace(-6.0, 6.0, 201)
    x, ld_f = p_rqs(z, xs_, ys_, ds_, inverse=False)
    z2, ld_i = p_rqs(x, xs_, ys_, ds_, inverse=True)
    _close(z2, z, 1e-4)
    _close(ld_f + ld_i, np.zeros(201), 1e-4)
    assert bool((torch.diff(x) > 0).all())
    grid = torch.linspace(-14, 14, 20001, dtype=torch.float64)
    p = torch.exp(port.log_prob(grid.float()).double())
    assert abs(float(torch.trapezoid(p, grid)) - 1.0) < 1e-3
    # the draws follow the density
    s = port.sample(torch.Generator().manual_seed(9), (N,)).double()
    m = float(torch.trapezoid(p * grid, grid))
    v = float(torch.trapezoid(p * grid * grid, grid)) - m * m
    _moments_within(s.numpy(), m, v, "spline flow")


def test_spline_flow_follows_float64_parameters():
    """With float64 parameters the flow computes in float64 (the
    reference: float32 always); float32 log_prob through the inverse
    spline is conditioned at ~2e-4 relative, which the float64 flow shows."""
    port, _ = _flows(3)
    p64 = pd.SplineFlow1D(*(t.double() for t in (port.w_logits, port.h_logits, port.d_raw,
                                                   port.loc, port.scale)))
    x = port.sample(torch.Generator().manual_seed(1), (4096,))
    lp32, lp64 = port.log_prob(x), p64.log_prob(x.double())
    assert lp32.dtype == torch.float32 and lp64.dtype == torch.float64
    assert p64.sample(torch.Generator().manual_seed(1), (8,)).dtype == torch.float64
    rel = ((lp32.double() - lp64).abs() / lp64.abs().clamp(min=1.0)).max()
    assert 0 < float(rel) < 1e-3


# ---------------------------------------------------------------------------
# transforms


TRANSFORM_CASES = {
    "normal": lambda m: m.Normal(0.0, 1.0),
    "student_t": lambda m: m.StudentT(3.0, 0.0, 1.0),
    "gamma": lambda m: m.Gamma(2.0, 1.0),
    "halfnormal": lambda m: m.HalfNormal(1.5),
    "uniform": lambda m: m.Uniform(-2.0, 5.0),
    "beta": lambda m: m.Beta(2.0, 3.0),
    "min_max_continuous": lambda m: m.MinMaxContinuous(0.0, 10.0, 3.0, 6.0),
    "truncated": lambda m: m.Truncated(m.Normal(0.0, 1.0), -1.0, 2.0),
}


def _port_module():
    """The port's classes with their parameters on the CPU."""
    class M:
        def __getattr__(self, name):
            cls = getattr(pd, name)
            return lambda *a: cls(*a, device="cpu")
    return M()


@pytest.mark.parametrize("key", sorted(TRANSFORM_CASES))
def test_transforms_match_jax_and_autograd(key):
    t_p = pt.biject_for(TRANSFORM_CASES[key](_port_module()))
    t_j = jt.biject_for(TRANSFORM_CASES[key](jd))
    z = np.linspace(-4, 4, 17).astype(F32)
    zt = torch.as_tensor(z, dtype=torch.float64).requires_grad_(True)
    x_p = t_p.forward(torch.as_tensor(z))
    _close(x_p, t_j.forward(jnp.asarray(z)), 1e-5)
    _close(t_p.log_det(torch.as_tensor(z)), t_j.log_det(jnp.asarray(z)), 1e-5)
    _close(t_p.inverse(x_p), t_j.inverse(t_j.forward(jnp.asarray(z))), 1e-4)
    # log_det is log |d forward / dz|, by autograd (float64)
    (grad,) = torch.autograd.grad(t_p.forward(zt).sum(), zt)
    _close(t_p.log_det(torch.as_tensor(z)), torch.log(grad.abs()), 1e-5)


def test_biject_for_discrete_is_none():
    assert pt.biject_for(pd.Poisson(3.0, device="cpu")) is None
    assert pt.biject_for(pd.Categorical(torch.ones(3))) is None
    assert pt.biject_for(pd.Normal(0.0, 1.0, device="cpu")) is pt.IDENTITY
    assert jt.biject_for(jd.Poisson(3.0)) is None


# ---------------------------------------------------------------------------
# the surface: names, vmap, devices


def test_the_reference_names_exist():
    import cpprob_tpu.distributions as ref

    assert pd.__all__ == ref.__all__
    for name in ref.__all__:
        assert hasattr(pd, name), name
    for name in ("Transform", "IDENTITY", "biject_for"):
        assert hasattr(pt, name)
    assert pd.Discrete is pd.Categorical and pd.Flip is pd.Bernoulli
    assert pd.Truncated._MAX_REJECTION_TRIES == jd.Truncated._MAX_REJECTION_TRIES == 1_000_000


@pytest.mark.parametrize("which", ["normal", "categorical", "truncated"])
def test_log_prob_under_vmap(which):
    """``log_prob`` branches on no value, so ``torch.func.vmap`` takes it:
    mapped over points, and over the parameters of a batch of
    distributions."""
    if which == "normal":
        dist = pd.Normal(0.5, 2.0, device="cpu")
        xs = torch.linspace(-3, 3, 11)
        make = lambda p: pd.Normal(p, torch.tensor(2.0))
        params = torch.linspace(-1, 1, 5)
    elif which == "categorical":
        dist = pd.Categorical(torch.tensor([0.2, 0.3, 0.5]))
        xs = torch.arange(-1, 5)
        make = lambda p: pd.Categorical(p)
        params = torch.rand(5, 3, generator=torch.Generator().manual_seed(0)) + 0.1
    else:
        dist = pd.Truncated(pd.Normal(0.5, 2.0, device="cpu"), -1.0, 3.0)
        xs = torch.linspace(-2, 4, 13)
        make = lambda p: pd.Truncated(pd.Normal(p, torch.tensor(2.0)), torch.tensor(-1.0),
                                      torch.tensor(3.0))
        params = torch.linspace(-1, 1, 5)
    got = torch.func.vmap(dist.log_prob)(xs)
    assert torch.equal(got, dist.log_prob(xs))
    x0 = xs[len(xs) // 2]
    by_param = torch.func.vmap(lambda p: make(p).log_prob(x0))(params)
    want = torch.stack([make(p).log_prob(x0) for p in params])
    torch.testing.assert_close(by_param, want)


def test_devices_follow_the_parameters():
    # numbers go to device=; tensors keep theirs; nested distributions decide
    n = pd.Normal(torch.zeros(3), 1.0)
    assert n.device.type == "cpu" and n.scale.device.type == "cpu"
    tr = pd.Truncated(n, -1.0, 1.0)
    assert tr.device.type == "cpu" and tr.low.device.type == "cpu"
    with pytest.raises(ValueError, match="several devices"):
        pd.Normal(torch.zeros(3), torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="generator draws on"):
        pd.Normal(torch.zeros(3, device="meta"), 1.0).sample(torch.Generator())
    if torch.cuda.is_available():
        assert pd.Normal(0.0, 1.0).device.type == "cuda"
    else:   # the default device is the card, and nothing falls back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            pd.Normal(0.0, 1.0)
    # float64 parameters give float64 results; numbers float32
    assert pd.Normal(torch.zeros((), dtype=torch.float64), 1.0).log_prob(0.0).dtype == \
        torch.float64
    assert pd.Normal(0.0, 1.0, device="cpu").log_prob(0.0).dtype == torch.float32


@pytest.mark.cuda
def test_distributions_on_the_card():
    """Draws from a CUDA generator land on the card; ``log_prob`` and
    ``cdf`` there equal the CPU's within 1e-6 relative (``chip_smoke.py``
    holds the same at 2^24 draws)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dist_cuda, dist_cpu in ((pd.Normal(1.0, 2.0), pd.Normal(1.0, 2.0, device="cpu")),
                                (pd.Beta(2.0, 3.0), pd.Beta(2.0, 3.0, device="cpu"))):
        x = dist_cuda.sample(gen, (4096,))
        assert x.device.type == "cuda"
        torch.testing.assert_close(dist_cuda.log_prob(x).cpu(), dist_cpu.log_prob(x.cpu()),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dist_cuda.cdf(x).cpu(), dist_cpu.cdf(x.cpu()),
                                   rtol=1e-6, atol=1e-6)
