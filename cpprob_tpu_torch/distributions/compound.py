"""Compound distributions: Mixture, Truncated, Dirac, ABC — counterpart of
``cpprob_tpu/distributions/compound.py`` (the reference's ``mixture.hpp``,
``truncated.hpp``, ``dirac_delta.hpp``, ``abc.hpp``):

- :class:`Mixture` stacks component parameters on a leading axis (a static
  component *count*, tensor parameters).
- :class:`Truncated` samples by the inverse CDF when the base has one
  (exact, branch-free) and otherwise by rejection, bounded like the
  reference's 1e6-try loop (``truncated.hpp:84-102``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .base import (
    Distribution,
    dist_dataclass,
    host_any,
    map_params,
    promote_to_result_dtype,
)
from .discrete import _gumbel_max

__all__ = ["Mixture", "Truncated", "Dirac", "ABC", "DefensiveMixture", "make_abc"]

_NEG_INF = -math.inf


@dist_dataclass
class Mixture(Distribution):
    """Finite mixture.  ``components`` is a single distribution whose
    parameter tensors carry a leading component axis of size K; ``weights``
    is an unnormalized (K,) vector (cf. ``mixture.hpp:14-160``,
    coefficients via ``discrete_distribution``)."""

    components: Any        # Distribution with a leading K axis on every parameter
    weights: torch.Tensor  # (K,)

    @property
    def num_components(self):
        return self.weights.shape[-1]

    def _component(self, k):
        return map_params(self.components, lambda t: t[k])

    def _log_weights(self):
        (w,) = promote_to_result_dtype(self.weights)
        logw = torch.log(w)
        return logw - torch.logsumexp(logw, dim=-1, keepdim=True)

    def sample(self, generator, sample_shape=()):
        device = self._device_of(generator)
        idx = _gumbel_max(generator, self._log_weights(), sample_shape, device)
        if tuple(sample_shape) == ():
            return self._component(idx).sample(generator)
        # one draw from every component for each output element, then a
        # selection: no data-dependent shapes
        all_draws = torch.stack([self._component(k).sample(generator, sample_shape)
                                 for k in range(self.num_components)])
        return torch.gather(torch.movedim(all_draws, 0, -1), -1, idx[..., None])[..., 0]

    def _per_component(self, fn):
        """(K, ...) of ``fn`` over the components."""
        return torch.stack([fn(self._component(k)) for k in range(self.num_components)])

    def log_prob(self, x):
        logw = self._log_weights()
        comp_lp = self._per_component(lambda d: d.log_prob(x))  # (K, ...)
        logw_b = torch.movedim(
            logw.expand(comp_lp.shape[1:] + logw.shape[-1:]), -1, 0
        ) if comp_lp.ndim > 1 else logw
        return torch.logsumexp(comp_lp + logw_b, dim=0)

    def cdf(self, x):
        w = torch.exp(self._log_weights())
        comp_cdf = self._per_component(lambda d: d.cdf(x))  # (K, ...)
        w_b = torch.movedim(
            w.expand(comp_cdf.shape[1:] + w.shape[-1:]), -1, 0
        ) if comp_cdf.ndim > 1 else w
        return (w_b * comp_cdf).sum(0)

    @property
    def mean(self):
        w = torch.exp(self._log_weights())
        comp_means = self._per_component(lambda d: d.mean)
        return (w * comp_means).sum(0)


@dist_dataclass
class Truncated(Distribution):
    """Truncation of ``base`` to [low, high] (cf. ``truncated.hpp``;
    logpdf = base logpdf − log CDF-mass, ``utils_truncated.hpp:16-27``)."""

    base: Any
    low: torch.Tensor
    high: torch.Tensor

    _MAX_REJECTION_TRIES = 1_000_000  # reference bound, truncated.hpp:84-102

    @property
    def is_discrete(self):  # type: ignore[override]
        return self.base.is_discrete

    def _log_mass(self):
        return torch.log(self.base.cdf(self.high) - self.base.cdf(self.low))

    def sample(self, generator, sample_shape=()):
        base = self.base
        if hasattr(base, "icdf"):
            low, high = promote_to_result_dtype(self.low, self.high)
            u_lo = base.cdf(low)
            u_hi = base.cdf(high)
            shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(u_lo.shape,
                                                                       u_hi.shape))
            u = torch.rand(shape, generator=generator, dtype=u_lo.dtype,
                           device=self._device_of(generator))
            u = u_lo + (u_hi - u_lo) * u
            # Clamp away from exactly 0/1 for ndtri stability.
            fi = torch.finfo(u.dtype)
            u = torch.clamp(u, fi.tiny, 1.0 - fi.eps / 2)
            return torch.minimum(torch.maximum(base.icdf(u), low), high)
        return self._rejection_sample(generator, sample_shape)

    def _rejection_sample(self, generator, sample_shape):
        """Draws of ``base`` redrawn where they fall outside [low, high],
        all of them at once a round, for at most ``_MAX_REJECTION_TRIES``
        rounds, then clipped.  Each round reads one flag (whether any draw
        is still outside) back to the host: a synchronisation with the
        card a round (:func:`.base.host_any`), which ``sample`` by the
        inverse CDF does not have.  Under ``torch.func.vmap`` the flag is
        the whole population's, so a vmapped model samples it too."""
        self._device_of(generator)
        low, high = self.low, self.high
        x = self.base.sample(generator, sample_shape)
        tries = 0
        while tries < self._MAX_REJECTION_TRIES:
            bad = (x < low) | (x > high)
            if not host_any(bad, "truncated"):
                break
            x = torch.where(bad, self.base.sample(generator, sample_shape), x)
            tries += 1
        return torch.minimum(torch.maximum(x, low), high)

    def log_prob(self, x):
        x = self._as(x)
        inside = (x >= self.low) & (x <= self.high)
        lp = self.base.log_prob(x) - self._log_mass()
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        lo_cdf = self.base.cdf(self.low)
        hi_cdf = self.base.cdf(self.high)
        c = (self.base.cdf(x) - lo_cdf) / (hi_cdf - lo_cdf)
        return torch.clamp(c, 0.0, 1.0)


@dist_dataclass
class Dirac(Distribution):
    """Point mass (cf. ``dirac_delta.hpp``) — the sampler half of ABC pairs."""

    value: torch.Tensor

    def sample(self, generator, sample_shape=()):
        self._device_of(generator)
        v = self.value
        return v.expand(tuple(sample_shape) + tuple(v.shape))

    def log_prob(self, x):
        v = self.value
        x = self._as(x)
        eq = x == v
        # reduce over event dims if value is a vector
        while eq.ndim > max(x.ndim, v.ndim) - max(v.ndim, 0):
            eq = eq.all(-1)
        zero = torch.zeros(eq.shape, dtype=promote_to_result_dtype(v)[0].dtype,
                           device=eq.device)
        return torch.where(eq, zero, _NEG_INF)

    @property
    def mean(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class ABC(Distribution):
    """Approximate-Bayesian-computation 'distribution': an arbitrary sampler
    plus an arbitrary log-density for likelihood-free ``observe``
    (cf. ``abc.hpp:49-140``, ``make_abc``).  ``sampler(generator)`` returns
    one draw; ``logpdf_fn(x)`` its log-density."""

    sampler: Callable[[torch.Generator], torch.Tensor]
    logpdf_fn: Callable[[Any], torch.Tensor]

    def sample(self, generator, sample_shape=()):
        if tuple(sample_shape) != ():
            draws = [self.sampler(generator) for _ in range(math.prod(sample_shape))]
            flat = torch.stack([torch.as_tensor(d) for d in draws])
            return flat.reshape(tuple(sample_shape) + tuple(flat.shape[1:]))
        return self.sampler(generator)

    def log_prob(self, x):
        return self.logpdf_fn(x)


def make_abc(sampler, logpdf_fn):
    """Counterpart of ``cpprob::make_abc`` (``abc.hpp``)."""
    return ABC(sampler, logpdf_fn)


@dist_dataclass
class DefensiveMixture(Distribution):
    """Two-component defensive mixture over arbitrary (different-family)
    distributions: ``(1-lam) * proposal + lam * anchor``.

    The classic defensive-importance-sampling construction (Hesterberg
    1995): mixing a learned proposal with the prior bounds the importance
    weights by ``prior/...  <= 1/lam`` at any point the proposal
    under-covers, trading a (1-lam) efficiency factor for robustness to
    proposal over-confidence.  Unlike :class:`Mixture` the two components
    need not share a family or parameters."""

    proposal: Any
    anchor: Any
    lam: Any  # mixing weight on the anchor, in (0, 1)

    def sample(self, generator, sample_shape=()):
        device = self._device_of(generator)
        pick_anchor = torch.rand(tuple(sample_shape), generator=generator,
                                 device=device) < self.lam
        a = self.anchor.sample(generator, sample_shape)
        p = self.proposal.sample(generator, sample_shape)
        # components may carry event dims beyond sample_shape (e.g. MVN):
        # right-pad the per-draw pick with singleton axes so it broadcasts
        event_ndim = max(a.ndim, p.ndim) - pick_anchor.ndim
        if event_ndim > 0:
            pick_anchor = pick_anchor.reshape(pick_anchor.shape + (1,) * event_ndim)
        return torch.where(pick_anchor, a, p)

    def log_prob(self, x):
        lam = self.lam.float()
        return torch.logaddexp(
            torch.log1p(-lam) + self.proposal.log_prob(x),
            torch.log(lam) + self.anchor.log_prob(x),
        )
