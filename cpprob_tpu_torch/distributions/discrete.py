"""Discrete distributions — counterpart of
``cpprob_tpu/distributions/discrete.py`` (the reference's discrete Boost
adoptions, ``utils_discrete.hpp``, ``utils_poisson.hpp``,
``utils_uniform_smallint.hpp``, plus ``min_max_discrete.hpp``).

Draws are int64 tensors; ``log_prob`` broadcasts over batch shapes.
"""

from __future__ import annotations

import math

import torch

from .base import Distribution, dist_dataclass, promote_to_result_dtype

__all__ = [
    "Categorical",
    "Discrete",
    "UniformInt",
    "Poisson",
    "Bernoulli",
    "Flip",
    "MinMaxDiscrete",
]

_NEG_INF = -math.inf


def _gumbel_max(generator, logits, sample_shape, device):
    """Indices drawn from ``softmax(logits)`` (last axis) by the Gumbel-max
    trick: argmax of logits + G, G = -log(-log U), U uniform on [0, 1)."""
    shape = tuple(sample_shape) + tuple(logits.shape)
    u = torch.rand(shape, generator=generator, dtype=logits.dtype, device=device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@dist_dataclass
class Categorical(Distribution):
    """Distribution over {0..K-1} with unnormalized ``probs`` (last axis) —
    counterpart of ``boost::random::discrete_distribution`` (``utils_discrete.hpp:18-27``:
    logpdf normalizes by the probability sum)."""

    probs: torch.Tensor  # (..., K), unnormalized non-negative weights

    is_discrete = True

    @property
    def batch_shape(self):
        return tuple(self.probs.shape[:-1])

    def _logits(self):
        (p,) = promote_to_result_dtype(self.probs)
        return torch.log(p)

    def sample(self, generator, sample_shape=()):
        return _gumbel_max(generator, self._logits(), sample_shape,
                           self._device_of(generator))

    def log_prob(self, x):
        logits = self._logits()
        norm = torch.logsumexp(logits, dim=-1)
        x = self._as(x).long()
        k = logits.shape[-1]
        inside = (x >= 0) & (x < k)
        xc = torch.clamp(x, 0, k - 1)
        batch = torch.broadcast_shapes(logits.shape[:-1], x.shape)
        lp = torch.gather(logits.expand(batch + (k,)), -1,
                          xc.expand(batch)[..., None])[..., 0] - norm.expand(batch)
        return torch.where(inside, lp, _NEG_INF)

    @property
    def mean(self):
        (p,) = promote_to_result_dtype(self.probs)
        p = p / p.sum(-1, keepdim=True)
        k = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        return (p * k).sum(-1)

    @property
    def variance(self):
        (p,) = promote_to_result_dtype(self.probs)
        p = p / p.sum(-1, keepdim=True)
        k = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        m = (p * k).sum(-1)
        return (p * k * k).sum(-1) - m * m


# Reference name (protocol::Discrete).
Discrete = Categorical


@dist_dataclass
class UniformInt(Distribution):
    """Uniform over integers [low, high] inclusive — counterpart of
    ``boost::random::uniform_smallint`` (``utils_uniform_smallint.hpp``).
    Its CSIS proposal is :class:`MinMaxDiscrete`."""

    low: torch.Tensor
    high: torch.Tensor

    is_discrete = True

    def sample(self, generator, sample_shape=()):
        low, high = self.low.long(), self.high.long()
        shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(low.shape, high.shape))
        u = torch.rand(shape, generator=generator, dtype=torch.float64,
                       device=self._device_of(generator))
        k = torch.floor(u * (high - low + 1).double()).long()
        return torch.minimum(low + k, high)

    def log_prob(self, x):
        x = self._as(x)
        n = (self.high - self.low + 1).float()
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -torch.log(n), _NEG_INF)

    @property
    def mean(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        return 0.5 * (low + high)

    @property
    def variance(self):
        low, high = promote_to_result_dtype(self.low, self.high)
        n = high - low + 1.0
        return (n * n - 1.0) / 12.0


@dist_dataclass
class Poisson(Distribution):
    """Poisson(rate) — counterpart of ``boost::random::poisson_distribution``
    (``utils_poisson.hpp``)."""

    rate: torch.Tensor

    is_discrete = True

    def sample(self, generator, sample_shape=()):
        (rate,) = promote_to_result_dtype(self.rate)
        self._device_of(generator)
        shape = tuple(sample_shape) + tuple(rate.shape)
        return torch.poisson(rate.expand(shape).contiguous(), generator=generator).long()

    def log_prob(self, x):
        (rate,) = promote_to_result_dtype(self.rate)
        xf = self._as(x, rate.dtype)
        lp = xf * torch.log(rate) - rate - torch.lgamma(xf + 1.0)
        return torch.where(xf >= 0, lp, _NEG_INF)

    @property
    def mean(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return rate

    @property
    def variance(self):
        (rate,) = promote_to_result_dtype(self.rate)
        return rate


@dist_dataclass
class Bernoulli(Distribution):
    """Flip(p) — counterpart of the protocol's ``Flip`` table (``infcomp.fbs``)."""

    p: torch.Tensor

    is_discrete = True

    def sample(self, generator, sample_shape=()):
        (p,) = promote_to_result_dtype(self.p)
        u = torch.rand(tuple(sample_shape) + tuple(p.shape), generator=generator,
                       dtype=p.dtype, device=self._device_of(generator))
        return (u < p).long()

    def log_prob(self, x):
        (p,) = promote_to_result_dtype(self.p)
        x = self._as(x, p.dtype)
        return torch.where(x == 1, torch.log(p), torch.log1p(-p))

    @property
    def mean(self):
        (p,) = promote_to_result_dtype(self.p)
        return p

    @property
    def variance(self):
        (p,) = promote_to_result_dtype(self.p)
        return p * (1.0 - p)


Flip = Bernoulli


@dist_dataclass
class MinMaxDiscrete(Distribution):
    """Discrete distribution with explicit integer support [low, low+K-1] —
    counterpart of ``min_max_discrete_distribution`` (``min_max_discrete.hpp``),
    the CSIS proposal for :class:`UniformInt`."""

    low: torch.Tensor
    probs: torch.Tensor  # (..., K) unnormalized weights over [low, low+K-1]

    is_discrete = True

    @property
    def batch_shape(self):
        return tuple(self.probs.shape[:-1])

    def _categorical(self):
        return Categorical(self.probs)

    def sample(self, generator, sample_shape=()):
        idx = self._categorical().sample(generator, sample_shape)
        return idx + self.low.long()

    def log_prob(self, x):
        return self._categorical().log_prob(self._as(x) - self.low)

    @property
    def mean(self):
        low, = promote_to_result_dtype(self.low)
        return self._categorical().mean + low

    @property
    def variance(self):
        return self._categorical().variance
