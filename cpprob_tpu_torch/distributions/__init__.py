"""The distribution layer — counterpart of ``cpprob_tpu/distributions``.

Every distribution is a frozen dataclass of tensors with batched
``sample(generator, sample_shape)`` / ``log_prob`` / ``cdf``
(``base.py`` states the device and generator conventions).
"""

from .base import Distribution, dist_dataclass
from .continuous import (
    Beta,
    Cauchy,
    Exponential,
    Gamma,
    HalfNormal,
    Laplace,
    LogNormal,
    MinMaxContinuous,
    MultivariateNormalDiag,
    MultivariateNormalFull,
    Normal,
    StudentT,
    Uniform,
)
from .discrete import (
    Bernoulli,
    Categorical,
    Discrete,
    Flip,
    MinMaxDiscrete,
    Poisson,
    UniformInt,
)
from .compound import ABC, DefensiveMixture, Dirac, Mixture, Truncated, make_abc
from .flow import SplineFlow1D

__all__ = [
    "Distribution",
    "dist_dataclass",
    "Normal",
    "Uniform",
    "Beta",
    "Gamma",
    "Laplace",
    "Exponential",
    "MultivariateNormalDiag",
    "MultivariateNormalFull",
    "MinMaxContinuous",
    "LogNormal",
    "HalfNormal",
    "StudentT",
    "Cauchy",
    "Categorical",
    "Discrete",
    "UniformInt",
    "Poisson",
    "Bernoulli",
    "Flip",
    "MinMaxDiscrete",
    "Mixture",
    "Truncated",
    "Dirac",
    "ABC",
    "DefensiveMixture",
    "make_abc",
    "SplineFlow1D",
]
