"""Conjugate-Gaussian models — counterpart of ``cpprob_tpu/models/gaussian.py``
(reference ``include/models/models.hpp:22-65``, ``src/models/gaussian.cpp:5-18``).

These are the correctness gates: with observations (3, 4) the exact posterior
of ``gaussian_unknown_mean_readme`` is N(2.32353, 1.05882) (``README.md:100,118``).
"""

from __future__ import annotations

import math

import numpy as np

from ..core import as_tensor, observe, predict, sample
from ..distributions import MultivariateNormalDiag, Normal

__all__ = [
    "gaussian_unknown_mean",
    "gaussian_unknown_mean_readme",
    "gaussian_2d_unknown_mean",
    "Gauss",
    "gaussian_posterior_analytic",
]

_SQRT5 = math.sqrt(5.0)
_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)


def gaussian_unknown_mean(y1, y2):
    """mu ~ N(1, sqrt(5)); y_i ~ N(mu, sqrt(2)) (``models.hpp:22-35``)."""
    mu = sample(Normal(1.0, _SQRT5), addr="mu")
    likelihood = Normal(mu, _SQRT2)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mu")
    return mu


def gaussian_unknown_mean_readme(y1, y2):
    """The README/gaussian.cpp variant (``src/models/gaussian.cpp:5-18``):
    mu ~ N(1, 1.5); y_i ~ N(mu, 2); predict "Mean".  With (3, 4) the exact
    posterior is N(2.32353, 1.05882) (``README.md:100,118``)."""
    mu = sample(Normal(1.0, 1.5), addr="mu")
    likelihood = Normal(mu, 2.0)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mean")
    return mu


class Gauss:
    """Callable-object form (tests functor support, ``models.hpp:51-65``)."""

    def __call__(self, y1, y2):
        return gaussian_unknown_mean(y1, y2)


def gaussian_2d_unknown_mean(y):
    """2-d diagonal-MVN unknown mean (``models.hpp:38-49``):
    mu ~ N([1,2], diag[sqrt5, sqrt3]); y ~ N(mu, sqrt2 * I)."""
    prior = MultivariateNormalDiag([1.0, 2.0], [_SQRT5, _SQRT3])
    mu = sample(prior, addr="mu")
    observe(MultivariateNormalDiag(mu, _SQRT2), as_tensor(y), addr="y")
    predict(mu, "Mu")
    return mu


def gaussian_posterior_analytic(ys, mu0=1.0, sigma0=_SQRT5, sigma=_SQRT2):
    """Exact conjugate posterior (mean, variance) of mu for checking
    estimates, host numpy in float64 (cf. ``README.md:118``: ys=(3,4),
    sigma0=1.5, sigma=2 -> mean 2.32353, var 1.05882)."""
    ys = np.atleast_1d(np.asarray(ys, np.float64))
    prec = 1.0 / (sigma0 * sigma0) + ys.shape[0] / (sigma * sigma)
    var_n = 1.0 / prec
    mean_n = var_n * (mu0 / (sigma0 * sigma0) + np.sum(ys) / (sigma * sigma))
    return mean_n, var_n
