"""Continuous distributions — counterpart of
``cpprob_tpu/distributions/continuous.py``.

All are batched dataclasses of tensors: parameters may be scalars or
tensors, and ``sample``/``log_prob`` broadcast.  ``cdf`` is provided where
the reference provides it.  ``Beta.cdf`` is the regularized incomplete beta
function, which torch lacks: :func:`betainc` below, a continued fraction
in float64 with a fixed number of steps.
"""

from __future__ import annotations

import math

import torch

from .base import Distribution, dist_dataclass, promote_to_result_dtype

__all__ = [
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
]

_HALF_LOG_2PI = 0.9189385332046727417803297364056176
_NEG_INF = -math.inf

# steps of betainc's continued fraction: enough to converge to ~1e-12 for
# a, b up to 1e4 (it needs O(sqrt(max(a, b))) steps)
BETAINC_STEPS = 100
_TINY = 1e-300


def _shape(sample_shape, *params) -> tuple:
    return tuple(sample_shape) + tuple(torch.broadcast_shapes(*(p.shape for p in params)))


def betaln(a, b):
    """log B(a, b)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betainc(a, b, x) -> torch.Tensor:
    """The regularized incomplete beta function I_x(a, b), elementwise over
    broadcast tensors (the counterpart of ``jax.scipy.special.betainc``).

    The continued fraction of Numerical Recipes §6.4 by the modified Lentz
    method, in float64, for x below (a + 1) / (a + b + 2) and through I_x(a,
    b) = 1 - I_{1-x}(b, a) above it, with ``BETAINC_STEPS`` steps always:
    no step depends on a value, so it never synchronises with the card.
    NaN where a or b is not positive or x lies outside [0, 1].  Returned in
    the inputs' promoted dtype."""
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    flip = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(flip, b, a)
    q = torch.where(flip, a, b)
    y = torch.where(flip, 1.0 - x, x)
    qab, qap, qam = p + q, p + 1.0, p - 1.0

    def guard(v):
        return torch.where(v.abs() < _TINY, _TINY, v)

    c = torch.ones_like(y)
    d = 1.0 / guard(1.0 - qab * y / qap)
    h = d
    for m in range(1, BETAINC_STEPS + 1):
        m2 = 2 * m
        for num in (m * (q - m) * y / ((qam + m2) * (p + m2)),
                    -(p + m) * (qab + m) * y / ((p + m2) * (qap + m2))):
            d = 1.0 / guard(1.0 + num * d)
            c = guard(1.0 + num / c)
            h = h * d * c
    front = torch.exp(p * torch.log(y) + q * torch.log1p(-y) - betaln(p, q)) / p
    r = front * h
    out = torch.where(flip, 1.0 - r, r)
    bad = (a <= 0) | (b <= 0) | (x < 0) | (x > 1)
    return torch.where(bad, math.nan, out).to(dtype if dtype.is_floating_point
                                             else torch.float32)


def _beta_logpdf(x, a, b):
    """``jax.scipy.stats.beta.logpdf(x, a, b)``: -inf outside [0, 1], NaN
    where a or b is not positive."""
    lp = (torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
          - betaln(a, b))
    lp = torch.where((x > 1.0) | (x < 0.0), _NEG_INF, lp)
    return torch.where((a <= 0) | (b <= 0), math.nan, lp)


def _beta_draw(generator, a, b, shape):
    """Beta(a, b) draws of ``shape``: two standard gammas, x = g_a / (g_a +
    g_b)."""
    ga = torch._standard_gamma(a.expand(shape).contiguous(), generator=generator)
    gb = torch._standard_gamma(b.expand(shape).contiguous(), generator=generator)
    return ga / (ga + gb)


@dist_dataclass
class Normal(Distribution):
    """N(loc, scale).  scale==0 degenerates to a Dirac delta, matching the
    reference's sigma=0 convention (``utils_normal_distribution.hpp:21-45``)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        eps = torch.randn(_shape(sample_shape, loc, scale), generator=generator,
                          dtype=loc.dtype, device=self._device_of(generator))
        return loc + scale * eps

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        # sigma == 0 => Dirac: 0 where x == loc else -inf
        safe_scale = torch.where(scale == 0, 1.0, scale)
        z = (x - loc) / safe_scale
        lp = -0.5 * z * z - torch.log(safe_scale) - _HALF_LOG_2PI
        dirac = torch.where(x == loc, torch.zeros_like(lp), _NEG_INF)
        return torch.where(scale == 0, dirac, lp)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        # sigma == 0 => Dirac: step function at loc (0 below, 1 at/above)
        safe_scale = torch.where(scale == 0, 1.0, scale)
        c = torch.special.ndtr((x - loc) / safe_scale)
        step = torch.where(x >= loc, torch.ones_like(c), torch.zeros_like(c))
        return torch.where(scale == 0, step, c)

    def icdf(self, u):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        # sigma == 0 => all quantiles collapse to loc (and 0*ndtri(0)=nan is
        # avoided explicitly)
        q = torch.special.ndtri(self._as(u, loc.dtype))
        return torch.where(scale == 0, loc, loc + scale * q)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return (self.scale * self.scale).expand(self.batch_shape)


@dist_dataclass
class Uniform(Distribution):
    """Uniform(low, high) on the half-open interval [low, high).

    Counterpart of ``boost::random::uniform_real_distribution``
    (``utils_uniform_real.hpp``)."""

    low: torch.Tensor
    high: torch.Tensor

    def sample(self, generator, sample_shape=()):
        low, high = promote_to_result_dtype(self.low, self.high)
        u = torch.rand(_shape(sample_shape, low, high), generator=generator,
                       dtype=low.dtype, device=self._device_of(generator))
        return low + (high - low) * u

    def log_prob(self, x):
        low, high = promote_to_result_dtype(self.low, self.high)
        x = self._as(x, low.dtype)
        inside = (x >= low) & (x <= high)
        # degenerate low == high => Dirac at low (log_prob 0 there, -inf off)
        width = high - low
        lp = torch.where(width == 0, 0.0, -torch.log(torch.where(width == 0, 1.0, width)))
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        low, high = promote_to_result_dtype(self.low, self.high)
        x = self._as(x, low.dtype)
        width = high - low
        safe = torch.where(width == 0, 1.0, width)
        c = torch.clamp((x - low) / safe, 0.0, 1.0)
        step = torch.where(x >= low, torch.ones_like(c), torch.zeros_like(c))
        return torch.where(width == 0, step, c)

    def icdf(self, u):
        low, high = promote_to_result_dtype(self.low, self.high)
        return low + (high - low) * self._as(u, low.dtype)

    @property
    def mean(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        return (0.5 * (low + high)).expand(self.batch_shape)

    @property
    def variance(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        d = high - low
        return (d * d / 12.0).expand(self.batch_shape)


@dist_dataclass
class Beta(Distribution):
    alpha: torch.Tensor
    beta: torch.Tensor

    def sample(self, generator, sample_shape=()):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        self._device_of(generator)
        return _beta_draw(generator, a, b, _shape(sample_shape, a, b))

    def log_prob(self, x):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return _beta_logpdf(self._as(x, a.dtype), a, b)

    def cdf(self, x):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return betainc(a, b, torch.clamp(self._as(x, a.dtype), 0.0, 1.0))

    @property
    def mean(self):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        return (a / (a + b)).expand(self.batch_shape)

    @property
    def variance(self):
        a, b = promote_to_result_dtype(self.alpha, self.beta)
        s = a + b
        return (a * b / (s * s * (s + 1))).expand(self.batch_shape)


@dist_dataclass
class Gamma(Distribution):
    """Gamma(shape=concentration, scale).  Boost parameterizes by (alpha, beta=scale)."""

    concentration: torch.Tensor
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        self._device_of(generator)
        g = torch._standard_gamma(a.expand(_shape(sample_shape, a, scale)).contiguous(),
                                  generator=generator)
        return g * scale

    def log_prob(self, x):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        x = self._as(x, a.dtype)
        ok = x >= 0
        y = torch.where(ok, x / scale, 1.0)
        lp = torch.xlogy(a - 1.0, y) - y - (torch.lgamma(a) + torch.log(scale))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        x = self._as(x, a.dtype)
        return torch.special.gammainc(a, torch.clamp(x, min=0.0) / scale)

    @property
    def mean(self):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        return (a * scale).expand(self.batch_shape)

    @property
    def variance(self):
        a, scale = promote_to_result_dtype(self.concentration, self.scale)
        return (a * scale * scale).expand(self.batch_shape)


@dist_dataclass
class Laplace(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        u = torch.rand(_shape(sample_shape, loc, scale), generator=generator,
                       dtype=loc.dtype, device=self._device_of(generator))
        # u in (-1, 1): the reference's inverse CDF
        u = 2.0 * u - 1.0
        u = torch.where(u == -1.0, -1.0 + torch.finfo(loc.dtype).eps / 2, u)
        return loc + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        z = (x - loc) / scale
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return (2.0 * self.scale * self.scale).expand(self.batch_shape)


@dist_dataclass
class Exponential(Distribution):
    rate: torch.Tensor

    def sample(self, generator, sample_shape=()):
        (rate,) = promote_to_result_dtype(self.rate)
        e = torch.empty(_shape(sample_shape, rate), dtype=rate.dtype,
                        device=self._device_of(generator))
        return e.exponential_(generator=generator) / rate

    def log_prob(self, x):
        (rate,) = promote_to_result_dtype(self.rate)
        x = self._as(x, rate.dtype)
        return torch.where(x >= 0, torch.log(rate) - rate * x, _NEG_INF)

    def cdf(self, x):
        (rate,) = promote_to_result_dtype(self.rate)
        x = self._as(x, rate.dtype)
        return torch.where(x >= 0, 1.0 - torch.exp(-rate * x), 0.0)

    @property
    def mean(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return 1.0 / rate

    @property
    def variance(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return 1.0 / (rate * rate)


@dist_dataclass
class MultivariateNormalDiag(Distribution):
    """Diagonal-covariance MVN — the reference's ``multivariate_normal_distribution``
    is exactly a vector of independent normals plus a shape
    (``include/cpprob/distributions/multivariate_normal.hpp``)."""

    loc: torch.Tensor    # (..., d)
    scale: torch.Tensor  # (..., d) or scalar

    event_ndim = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    def sample(self, generator, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        eps = torch.randn(_shape(sample_shape, loc, scale.expand(loc.shape)),
                          generator=generator, dtype=loc.dtype,
                          device=self._device_of(generator))
        return loc + scale * eps

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        scale_b = scale.expand(loc.shape)
        z = (x - loc) / scale_b
        per_dim = -0.5 * z * z - torch.log(scale_b) - _HALF_LOG_2PI
        return per_dim.sum(-1)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        s = self.scale.expand(self.loc.shape)
        return s * s


@dist_dataclass
class MultivariateNormalFull(Distribution):
    """Full-covariance MVN, Cholesky-parameterized (beyond the reference's
    diagonal-only ``multivariate_normal_distribution``).  ``scale_tril`` is
    the lower-triangular Cholesky factor of the covariance."""

    loc: torch.Tensor         # (..., d)
    scale_tril: torch.Tensor  # (..., d, d) lower triangular

    event_ndim = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    @classmethod
    def from_covariance(cls, loc, cov, *, device="cuda"):
        """The MVN of mean ``loc`` and covariance ``cov`` (tensors, or
        numbers and numpy arrays put on ``device``)."""
        loc = loc if isinstance(loc, torch.Tensor) else torch.as_tensor(loc, device=device)
        cov = torch.as_tensor(cov, device=loc.device)
        return cls(loc, torch.linalg.cholesky(cov))

    def sample(self, generator, sample_shape=()):
        loc, = promote_to_result_dtype(self.loc)
        tril = self.scale_tril.to(loc.dtype)
        eps = torch.randn(tuple(sample_shape) + tuple(loc.shape), generator=generator,
                          dtype=loc.dtype, device=self._device_of(generator))
        return loc + torch.einsum("...ij,...j->...i", tril, eps)

    def log_prob(self, x):
        loc, = promote_to_result_dtype(self.loc)
        tril = self.scale_tril.to(loc.dtype)
        x = self._as(x, loc.dtype)
        d = loc.shape[-1]
        diff = x - loc
        batch = torch.broadcast_shapes(diff.shape[:-1], tril.shape[:-2])
        z = torch.linalg.solve_triangular(
            tril.expand(batch + (d, d)), diff.expand(batch + (d,))[..., None],
            upper=False)[..., 0]
        log_det = torch.log(torch.abs(torch.diagonal(tril, dim1=-2, dim2=-1))).sum(-1)
        return -0.5 * (z * z).sum(-1) - log_det - d * _HALF_LOG_2PI

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return (self.scale_tril * self.scale_tril).sum(-1)


@dist_dataclass
class LogNormal(Distribution):
    """exp(N(loc, scale)) — beyond the reference's set (extension for
    hierarchical/positive-scale modeling)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def _normal(self):
        return Normal(self.loc, self.scale, device=self.device)

    def sample(self, generator, sample_shape=()):
        return torch.exp(self._normal().sample(generator, sample_shape))

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        safe_x = torch.clamp(x, min=torch.finfo(loc.dtype).tiny)
        lp = Normal(loc, scale).log_prob(torch.log(safe_x)) - torch.log(safe_x)
        return torch.where(x > 0, lp, _NEG_INF)

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        safe_x = torch.clamp(x, min=torch.finfo(loc.dtype).tiny)
        return torch.where(x > 0, Normal(loc, scale).cdf(torch.log(safe_x)), 0.0)

    @property
    def mean(self):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        return torch.exp(loc + 0.5 * scale * scale)

    @property
    def variance(self):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        s2 = scale * scale
        return (torch.exp(s2) - 1.0) * torch.exp(2.0 * loc + s2)


@dist_dataclass
class HalfNormal(Distribution):
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        (scale,) = promote_to_result_dtype(self.scale)
        eps = torch.randn(_shape(sample_shape, scale), generator=generator,
                          dtype=scale.dtype, device=self._device_of(generator))
        return torch.abs(eps) * scale

    def log_prob(self, x):
        (scale,) = promote_to_result_dtype(self.scale)
        x = self._as(x, scale.dtype)
        lp = Normal(torch.zeros_like(scale), scale).log_prob(x) + math.log(2.0)
        return torch.where(x >= 0, lp, _NEG_INF)

    def cdf(self, x):
        (scale,) = promote_to_result_dtype(self.scale)
        x = self._as(x, scale.dtype)
        return torch.where(x >= 0, 2.0 * Normal(torch.zeros_like(scale), scale).cdf(x) - 1.0,
                           0.0)

    @property
    def mean(self):
        (scale,) = promote_to_result_dtype(self.scale)
        return scale * math.sqrt(2.0 / math.pi)

    @property
    def variance(self):
        (scale,) = promote_to_result_dtype(self.scale)
        return scale * scale * (1.0 - 2.0 / math.pi)


@dist_dataclass
class StudentT(Distribution):
    df: torch.Tensor
    loc: torch.Tensor
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        df, loc, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        shape = _shape(sample_shape, df, loc, scale)
        # a normal over sqrt(chi2 / df), chi2 / 2 a Gamma(df / 2) draw
        n = torch.randn(shape, generator=generator, dtype=loc.dtype,
                        device=self._device_of(generator))
        half_df = (0.5 * df).expand(shape).contiguous()
        g = torch._standard_gamma(half_df, generator=generator)
        return loc + scale * (n * torch.sqrt(half_df / g))

    def log_prob(self, x):
        df, loc, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        x = self._as(x, loc.dtype)
        z = (x - loc) / scale
        half = 0.5 * (df + 1.0)
        return (
            torch.lgamma(half)
            - torch.lgamma(0.5 * df)
            - 0.5 * torch.log(df * math.pi)
            - torch.log(scale)
            - half * torch.log1p(z * z / df)
        )

    @property
    def mean(self):
        df, loc, _ = promote_to_result_dtype(self.df, self.loc, self.scale)
        return torch.where(df > 1, loc, math.nan)

    @property
    def variance(self):
        df, _, scale = promote_to_result_dtype(self.df, self.loc, self.scale)
        return torch.where(df > 2, scale * scale * df / (df - 2.0), math.nan)


@dist_dataclass
class Cauchy(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor

    def sample(self, generator, sample_shape=()):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        u = torch.rand(_shape(sample_shape, loc, scale), generator=generator,
                       dtype=loc.dtype, device=self._device_of(generator))
        u = torch.clamp(u, min=torch.finfo(loc.dtype).eps)
        return loc + scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        z = (x - loc) / scale
        return -torch.log(math.pi * scale * (1.0 + z * z))

    def cdf(self, x):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        x = self._as(x, loc.dtype)
        return 0.5 + torch.arctan((x - loc) / scale) / math.pi

    def icdf(self, u):
        loc, scale = promote_to_result_dtype(self.loc, self.scale)
        return loc + scale * torch.tan(math.pi * (self._as(u, loc.dtype) - 0.5))


@dist_dataclass
class MinMaxContinuous(Distribution):
    """Beta distribution reparameterized by (min, max, mode, certainty) —
    counterpart of the reference's (deprecated) ``min_max_continuous_distribution``
    (``min_max_continuous.hpp``): alpha = mode_01*(k-2)+1, beta = (1-mode_01)*(k-2)+1,
    scaled from [0,1] to [min,max]."""

    low: torch.Tensor
    high: torch.Tensor
    mode: torch.Tensor
    certainty: torch.Tensor  # k > 2

    def _ab(self):
        low, high, mode, k = promote_to_result_dtype(self.low, self.high, self.mode,
                                                     self.certainty)
        m01 = (mode - low) / (high - low)
        alpha = m01 * (k - 2.0) + 1.0
        beta = (1.0 - m01) * (k - 2.0) + 1.0
        return low, high, alpha, beta

    def sample(self, generator, sample_shape=()):
        low, high, alpha, beta = self._ab()
        self._device_of(generator)
        x01 = _beta_draw(generator, alpha, beta, _shape(sample_shape, alpha, beta))
        return low + (high - low) * x01

    def log_prob(self, x):
        low, high, alpha, beta = self._ab()
        x = self._as(x, alpha.dtype)
        x01 = (x - low) / (high - low)
        return _beta_logpdf(x01, alpha, beta) - torch.log(high - low)

    @property
    def mean(self):
        low, high, alpha, beta = self._ab()
        return low + (high - low) * alpha / (alpha + beta)
