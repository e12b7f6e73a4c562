"""The port's SVI and predictive sampling (``cpprob_tpu_torch.inference.svi``,
``predictive``) against the JAX package's.

- Exact: ``_tril_unpack``; the negative ELBO and its gradient at pinned
  standard-normal draws for both guides (the reference's ``neg_elbo``,
  nested in ``svi``, transcribed); one Adam step against optax's step of
  the port's own gradient (Adam's first step magnifies a gradient
  component near its ε, so the step is held to optax on the same
  gradient); an ``SVIResult`` carried across by
  ``interop.svi_result_from_numpy`` (its covariance exactly, its draws by
  their moments).
- Statistics: ``tests/test_hmc_svi.py``'s CSIS warm start and predictive
  moments, with its tolerances.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu.distributions as jd
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.distributions as pd
from cpprob_tpu_torch.interop import svi_result_from_numpy
from cpprob_tpu_torch.inference.predictive import posterior_predictive, prior_predictive

# the packages' ``inference.svi`` attributes are functions, not the modules
jsvi, jpot = (importlib.import_module(f"cpprob_tpu.inference.{m}") for m in ("svi", "potential"))
psvi, ppot = (importlib.import_module(f"cpprob_tpu_torch.inference.{m}")
              for m in ("svi", "potential"))

torch.set_num_threads(2)

README_MEAN, README_VAR = 2.32353, 1.05882
DATA = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.int32)
Y = np.array([1.5, -0.5], np.float32)


def _models(ct, D):
    def beta_bernoulli(y):
        p = ct.sample(D.Beta(2.0, 2.0), addr="p")
        for i in range(y.shape[0]):
            ct.observe(D.Bernoulli(p), y[i], addr=f"y[{i}]")

    def correlated(y):
        """tests/test_hmc_svi.py's TestSVIFullRank model."""
        x0 = ct.sample(D.Normal(0.0, 1.0), addr="x0")
        x1 = ct.sample(D.Normal(0.0, 1.0), addr="x1")
        ct.observe(D.Normal(x0 + x1, 0.5), y[0], addr="y0")
        ct.observe(D.Normal(x1, 0.5), y[1], addr="y1")

    def two_sites(y):
        s = ct.sample(D.Gamma(2.0, 1.0), addr="s")
        m = ct.sample(D.Normal(0.0, 2.0), addr="m")
        ct.observe(D.Normal(m, s), y[0], addr="y0")
        ct.observe(D.Normal(m, s), y[1], addr="y1")

    return {
        "readme": (ct.models.gaussian_unknown_mean_readme, (3.0, 4.0)),
        "beta_bernoulli": (beta_bernoulli, (DATA,)),
        "correlated": (correlated, (Y,)),
        "two_sites": (two_sites, (Y,)),
    }


JMODELS = _models(jt, jd)
PMODELS = _models(pt, pd)


def _flats(name):
    model, args = JMODELS[name]
    jflat = jpot.flatten_model(model, args)
    model, args = PMODELS[name]
    return jflat, ppot.flatten_model(model, args, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dim", [1, 2, 3, 5])
def test_tril_unpack_matches_reference(dim):
    flat = np.random.RandomState(dim).randn(dim * (dim + 1) // 2).astype(np.float32) * 3
    _close(psvi._tril_unpack(torch.as_tensor(flat), dim), jsvi._tril_unpack(flat, dim), 1e-6)


def _reference_neg_elbo(jflat, guide, params, eps):
    """The reference's ``neg_elbo`` (``cpprob_tpu/inference/svi.py:90-107``),
    transcribed, at the pinned draws ``eps``."""
    dim = jflat.dim
    if guide == "fullrank":
        loc, flat_tril = params
        L = jsvi._tril_unpack(flat_tril, dim)
        logp = jax.vmap(jflat.log_joint)(loc + eps @ L.T)
        entropy = jnp.sum(jnp.log(jnp.diagonal(L))) + dim * jsvi._HALF_LOG_2PI_E
    else:
        loc, log_scale = params
        logp = jax.vmap(jflat.log_joint)(loc + jnp.exp(log_scale) * eps)
        entropy = jnp.sum(log_scale) + dim * jsvi._HALF_LOG_2PI_E
    return -(jnp.mean(logp) + entropy)


def _guide_params(guide, dim, rng):
    loc = rng.randn(dim).astype(np.float32) * 0.5
    if guide == "fullrank":
        return loc, rng.randn(dim * (dim + 1) // 2).astype(np.float32) * 0.5
    return loc, rng.randn(dim).astype(np.float32) * 0.5 - 1.0


@pytest.mark.parametrize("name,guide", [("readme", "meanfield"), ("beta_bernoulli", "meanfield"),
                                        ("two_sites", "meanfield"), ("correlated", "fullrank"),
                                        ("two_sites", "fullrank")])
def test_neg_elbo_and_gradient_with_pinned_draws(name, guide):
    jflat, pflat = _flats(name)
    rng = np.random.RandomState(0)
    params = _guide_params(guide, jflat.dim, rng)
    eps = rng.randn(8, jflat.dim).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda p: _reference_neg_elbo(jflat, guide, p, eps))(params)
    tp = [torch.as_tensor(p).requires_grad_() for p in params]
    got = psvi.make_neg_elbo(pflat, guide)(tp, torch.as_tensor(eps))
    got.backward()
    _close(got, want, 1e-5, "neg_elbo")
    for t, w in zip(tp, want_g):
        _close(t.grad, w, 1e-5, "gradient")


@pytest.mark.parametrize("name,guide", [("two_sites", "meanfield"), ("correlated", "fullrank")])
def test_one_adam_step_is_optax_step(name, guide):
    """The port's first step against optax's Adam step of the port's own
    gradient at the same draws (the first thing ``svi`` draws when
    ``init_loc`` is given)."""
    _, pflat = _flats(name)
    model, args = PMODELS[name]
    dim, seed, lr = pflat.dim, 11, 0.05
    init = np.linspace(-0.5, 0.5, dim).astype(np.float32)
    res = psvi.svi(model, args, seed, guide=guide, steps=1, learning_rate=lr, init_loc=init,
                   device="cpu")
    eps = torch.randn((8, dim), generator=torch.Generator().manual_seed(seed))
    params = [p.clone().requires_grad_()
              for p in psvi.init_params(pflat, guide, torch.as_tensor(init))]
    psvi.make_neg_elbo(pflat, guide)(params, eps).backward()
    np_params = tuple(_np(p) for p in params)
    opt = optax.adam(lr)
    upd, _ = opt.update(tuple(_np(p.grad) for p in params), opt.init(np_params))
    loc, second = optax.apply_updates(np_params, upd)
    _close(res.loc, loc, 1e-6, "loc")
    if guide == "fullrank":
        _close(res.scale_tril, jsvi._tril_unpack(second, dim), 1e-6, "scale_tril")
    else:
        _close(res.log_scale, second, 1e-6, "log_scale")
    assert res.losses.shape == (1,)


def _sample_moments(samples, name):
    x = _np(samples[name]).reshape(len(_np(samples[name])), -1).astype(np.float64)
    return x.mean(0), x.std(0) / np.sqrt(len(x)), np.cov(x.T)


@pytest.mark.parametrize("name,guide", [("beta_bernoulli", "meanfield"), ("two_sites", "meanfield"),
                                        ("correlated", "fullrank")])
def test_svi_result_carried_across(name, guide):
    """A JAX ``SVIResult`` carried into the port: the same covariance, and
    draws with the same moments."""
    jflat, pflat = _flats(name)
    model, args = JMODELS[name]
    jres = jsvi.svi(model, args, jax.random.key(0), guide=guide, steps=200)
    pres = svi_result_from_numpy(jres.loc, jres.log_scale, pflat, jres.scale_tril, device="cpu")
    _close(pres.covariance_unconstrained(), jres.covariance_unconstrained(), 1e-6, "covariance")
    n = 1 << 16
    js, ps = jres.sample(jax.random.key(1), n), pres.sample(1, n)
    for pl in pflat.latents:
        jm, jse, jcov = _sample_moments(js, pl.addr)
        pm_, pse, pcov = _sample_moments(ps, pl.addr)
        assert np.all(np.abs(pm_ - jm) <= 4 * np.hypot(jse, pse)), (pl.addr, pm_, jm)
        np.testing.assert_allclose(pcov, jcov, rtol=0.05, atol=1e-3)
        _close(pres.mean(2, pl.addr, n), pm_.reshape(pres.mean(2, pl.addr, n).shape),
               5 * pse.max(), "mean")


def test_unknown_guide_raises():
    model, args = PMODELS["readme"]
    with pytest.raises(ValueError, match="unknown guide"):
        psvi.svi(model, args, 0, guide="bogus", device="cpu")


def test_engines_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    model, args = PMODELS["readme"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psvi.svi(model, args, 0, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prior_predictive(model, args, 8, 0)


def test_csis_initialization():
    """A trained CSIS proposal's posterior mean as the SVI warm start
    (``tests/test_hmc_svi.py::TestSVIFullRank::test_csis_initialization``)."""
    model, args = PMODELS["readme"]
    engine = pt.CSIS(model, (0.0, 0.0), embedding_dim=32, device="cpu")
    params, _ = engine.compile(0, steps=150, batch_size=32)
    res_g = engine.infer(params, args, 2000, 1)
    init = [float(res_g.mean("Mean"))]
    warm = psvi.svi(model, args, 2, steps=400, init_loc=init, device="cpu")
    cold = psvi.svi(model, args, 2, steps=400, device="cpu")
    assert abs(float(warm.loc[0]) - README_MEAN) < 0.1
    assert float(warm.losses[:25].mean()) <= float(cold.losses[:25].mean()) + 0.5


def test_predictive_moments():
    model, args = PMODELS["readme"]
    res = psvi.svi(model, args, 0, steps=1500, device="cpu")
    obs_rep, predicts = posterior_predictive(model, args, res.sample(2, 4000), 3)
    y1 = _np(obs_rep["y1"])
    assert y1.shape == (4000,) and _np(predicts["Mean"]).shape == (4000,)
    assert abs(y1.mean() - README_MEAN) < 0.2
    assert abs(y1.var() - (README_VAR + 4.0)) < 0.5
    latents, obs = prior_predictive(model, (0.0, 0.0), 8000, 0, device="cpu")
    mu = _np(latents["mu"])
    assert abs(mu.mean() - 1.0) < 0.1
    assert abs(mu.std() - 1.5) < 0.1
    assert abs(_np(obs["y1"]).var() - (1.5 ** 2 + 4.0)) < 0.4


@pytest.mark.cuda
def test_svi_on_the_card_without_sync():
    """Every step queues its work without waiting on the host; the losses
    stay on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, args = PMODELS["readme"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = psvi.svi(model, args, 0, steps=200)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.losses.device.type == "cuda" and torch.isfinite(res.losses).all()
