"""Normal-prior-via-rejection-sampling model — counterpart of
``cpprob_tpu/models/rejection.py`` (reference ``include/models/models.hpp:82-112``):
the N(1, sqrt5) prior is simulated by rejection against its pdf.

The data-dependent ``do/while`` is the bounded
:func:`~cpprob_tpu_torch.core.primitives.rejection_sample` (one host read
a round under vmap), and the guard form uses addressed sites inside a
``rejection_sampling`` guard (:func:`guarded_rejection`, no host read).
"""

from __future__ import annotations

import math

import torch

from ..core import guarded_rejection, observe, predict, rejection_sample, sample
from ..core.handlers import as_tensor
from ..distributions import Normal, Uniform

__all__ = ["normal_rejection_sampling", "normal_rejection_sampling_guard"]

_MU0 = 1.0
_SIGMA0 = math.sqrt(5.0)
_SIGMA = math.sqrt(2.0)


def normal_rejection_sampling(y1, y2):
    prior = Normal(_MU0, _SIGMA0)
    max_pdf = torch.exp(prior.log_prob(_MU0))
    proposal = Uniform(_MU0 - 20.0 * _SIGMA0, _MU0 + 20.0 * _SIGMA0)
    accept_dist = Uniform(0.0, max_pdf)

    # The rejection loop's randomness comes from an uncontrolled site, so
    # the whole loop consumes exactly one address.
    gen = sample(_KeyDist(), addr="mu_rejection_key", control=False)
    mu, _ = rejection_sample(
        gen,
        propose=lambda g: proposal.sample(g),
        accept=lambda x, g: accept_dist.sample(g) <= torch.exp(prior.log_prob(x)),
        max_iters=1000,
    )
    likelihood = Normal(mu, _SIGMA)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mu")
    return mu


def normal_rejection_sampling_guard(y1, y2):
    """Guard-form of :func:`normal_rejection_sampling` (thesis ch. 6.2): the
    rejection loop's draws are *addressed* sites inside a
    ``rejection_sampling`` guard, so compile-mode trace dedup keeps only the
    accepted draw and the log-weight counts only its Radon–Nikodym term."""
    prior = Normal(_MU0, _SIGMA0)
    max_pdf = torch.exp(prior.log_prob(_MU0))
    # +-4 sigma envelope: accept prob ~ sqrt(2pi)/8 ~ 0.31 per attempt;
    # P(no accept in 32) ~ 6e-6 (bounded loop)
    proposal = Uniform(_MU0 - 4.0 * _SIGMA0, _MU0 + 4.0 * _SIGMA0)

    def accept(x):
        u = sample(Uniform(0.0, max_pdf), addr="u_accept", control=False)
        return u <= torch.exp(prior.log_prob(x))

    mu, _ = guarded_rejection(proposal, accept, addr="mu", max_iters=32)
    likelihood = Normal(mu, _SIGMA)
    observe(likelihood, y1, addr="y1")
    observe(likelihood, y2, addr="y2")
    predict(mu, "Mu")
    return mu


class _KeyDist:
    """Degenerate 'distribution' that emits the site's generator — lets a
    model route handler-provided randomness into combinators like
    :func:`cpprob_tpu_torch.rejection_sample`."""

    is_discrete = False
    event_ndim = 1

    def sample(self, generator, sample_shape=()):
        assert sample_shape == ()
        return generator

    def log_prob(self, x):
        return as_tensor(0.0)
