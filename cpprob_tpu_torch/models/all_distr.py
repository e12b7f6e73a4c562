"""Exercises every supported prior distribution — counterpart of
``cpprob_tpu/models/all_distr.py`` (reference ``src/models/models.cpp:13-47``).
"""

from __future__ import annotations

from ..core import observe, predict, sample
from ..distributions import (
    Bernoulli,
    Beta,
    Categorical,
    Gamma,
    Laplace,
    Mixture,
    MultivariateNormalDiag,
    Normal,
    Poisson,
    Truncated,
    Uniform,
    UniformInt,
)

__all__ = ["all_distr"]


def all_distr(_a=0, _b=0):
    """Sample, predict, and self-observe each distribution (the reference
    observes each drawn value under its own prior — a pure smoke model)."""
    v = sample(Normal(1.0, 2.0), addr="normal")
    predict(v, "normal")
    observe(Normal(1.0, 2.0), v, addr="o_normal")

    v = sample(UniformInt(2, 7), addr="uniform_int")
    predict(v, "uniform_int")
    observe(UniformInt(2, 7), v, addr="o_uniform_int")

    v = sample(Uniform(2.0, 9.5), addr="uniform_real")
    predict(v, "uniform_real")
    observe(Uniform(2.0, 9.5), v, addr="o_uniform_real")

    v = sample(Poisson(0.8), addr="poisson")
    predict(v, "poisson")
    observe(Poisson(0.8), v, addr="o_poisson")

    v = sample(
        MultivariateNormalDiag([1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 5.0, 3.0]),
        addr="mvn",
    )
    predict(v, "mvn")
    observe(
        MultivariateNormalDiag([1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 5.0, 3.0]),
        v,
        addr="o_mvn",
    )

    # Beyond the reference's five: the rest of the protocol's union
    # (infcomp.fbs:22-35).
    v = sample(Categorical([0.2, 0.3, 0.5]), addr="categorical")
    predict(v, "categorical")
    v = sample(Bernoulli(0.3), addr="flip")
    predict(v, "flip")
    v = sample(Beta(2.0, 3.0), addr="beta")
    predict(v, "beta")
    v = sample(Gamma(2.0, 1.5), addr="gamma")
    predict(v, "gamma")
    v = sample(Laplace(0.0, 1.0), addr="laplace")
    predict(v, "laplace")
    v = sample(
        Mixture(Normal([-1.0, 1.0], [0.5, 0.5]), [0.4, 0.6]),
        addr="mixture",
    )
    predict(v, "mixture")
    v = sample(Truncated(Normal(0.0, 1.0), -1.0, 2.0), addr="truncated")
    predict(v, "truncated")
    return v
