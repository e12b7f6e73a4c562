"""SMC² — sequential inference of static parameters AND states of a
state-space model (Chopin, Jacob & Papaspiliopoulos 2013) — counterpart of
``cpprob_tpu/inference/smc2.py``.

Outer level: parameter particles θ_i weighted by the running
particle-filter evidence estimate Ẑ_t(θ_i); inner level: one bootstrap
particle filter per θ.  When the outer ESS collapses, parameters are
resampled and rejuvenated by a particle-marginal Metropolis-Hastings
(PMMH) move whose acceptance uses a freshly re-run inner filter over the
observations seen so far.

States live as one (N_θ, N_x) population; the model's hooks are written
for one θ and one particle and run under two nested
``torch.func.vmap(..., randomness="different")``, every draw from one
``torch.Generator``.  The inner filters' systematic resampling is batched
over θ (one comb a row).  Whether a step rejuvenates is **one host read a
step**, of one flag, counted in ``distributions.base.HOST_READS["smc2"]``:
the reference's ``lax.cond`` runs only the branch it takes, and the
rejuvenating branch re-runs N_θ filters, too much to compute every step
and discard.  The re-run stops at the current step (the reference masks
the later ones, which changes nothing).  θ pytrees are flattened in JAX's
order (:mod:`cpprob_tpu_torch.util.pytree`: dicts by sorted key).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..distributions.base import host_any, to_device
from ..util.pytree import tree_flatten, tree_map, tree_unflatten
from .potential import engine_device
from .resampling import systematic_resample
from .sis import _generator

__all__ = ["ParamSSM", "SMC2Result", "smc2"]


@dataclasses.dataclass(frozen=True)
class ParamSSM:
    """Parameterized SSM protocol.  All callables take a parameter pytree
    ``theta`` (leaves: tensors) for one θ and one particle; ``key`` is a
    ``torch.Generator`` (the engine vmaps the hooks over θ and particles).

    - ``prior_sample(key) -> theta``; ``prior_logpdf(theta) -> logp``
    - ``init_sample(key, theta) -> x0``
    - ``step_sample(key, x, t, theta) -> x'``
    - ``obs_logpdf(x, y, t, theta) -> logp``
    """

    prior_sample: Callable
    prior_logpdf: Callable
    init_sample: Callable
    step_sample: Callable
    obs_logpdf: Callable


class SMC2Result(NamedTuple):
    thetas: dict                 # pytree with leading (N_theta,) axis
    log_weights: torch.Tensor    # (N_theta,) outer weights
    log_evidence: torch.Tensor   # scalar: log p(y_{1:T})
    rejuvenations: torch.Tensor  # (T,) bool
    accept_rate: torch.Tensor    # mean PMMH acceptance over rejuvenation epochs

    @property
    def normalized_weights(self):
        return torch.softmax(self.log_weights, 0)

    def mean(self, leaf_fn=lambda th: th):
        w = self.normalized_weights
        vals = torch.func.vmap(leaf_fn)(self.thetas)
        w = w.reshape(w.shape + (1,) * (vals.dim() - 1))
        return torch.sum(w * vals, 0)


def _lme(lw):
    """log-mean-exp over the last axis."""
    return torch.logsumexp(lw, -1) - math.log(float(lw.shape[-1]))


def _systematic_rows(gen, log_w):
    """Systematic ancestors for each row of ``log_w`` (R, N), one uniform a
    row: slot j of a row goes to the particle whose float64 CDF interval
    holds (u + j) / N."""
    r, n = log_w.shape
    cdf = torch.cumsum(torch.softmax(log_w.double(), -1), -1)
    cdf = cdf / cdf[:, -1:]
    u = torch.rand((r, 1), generator=gen, device=log_w.device, dtype=torch.float64)
    pos = (u + torch.arange(n, device=log_w.device, dtype=torch.float64)) / n
    return torch.clamp(torch.searchsorted(cdf, pos, right=True), max=n - 1)


def _gather_rows(x, idx):
    """``x[i, idx[i, j]]`` for (R, N, ...) ``x`` and (R, N) ``idx``."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def _take(tree, idx):
    return tree_map(lambda s: s[idx], tree)


def smc2(
    model: ParamSSM,
    observations,
    n_theta: int,
    n_x: int,
    key,
    *,
    ess_threshold: float = 0.5,
    rw_scale: float = 0.25,
    jit: bool = True,
    device="cuda",
) -> SMC2Result:
    """Run SMC² over observations (T, ...) on ``device``.

    ``rw_scale``: random-walk PMMH proposal scale, as a fraction of the
    current parameter-population standard deviation per leaf (adaptive).
    ``key``: a seed or a generator.
    """
    dev = engine_device(device)
    gen = _generator(key, dev)
    obs = to_device(observations, dev)
    T = obs.shape[0]
    rand = dict(randomness="different")
    x_dummy = torch.empty(n_x, device=dev)

    def pf_init(thetas):
        """Every θ's initial particles, weights and log Ẑ_0."""
        xs = torch.func.vmap(lambda th: torch.func.vmap(
            lambda _: model.init_sample(gen, th), **rand)(x_dummy), **rand)(thetas)
        lw = obs_lp(xs, thetas, 0)
        return xs, lw, _lme(lw)

    def obs_lp(xs, thetas, t):
        return torch.func.vmap(lambda x_row, th: torch.func.vmap(
            lambda x: model.obs_logpdf(x, obs[t], t, th))(x_row))(xs, thetas)

    def pf_step(xs, lw, thetas, t):
        """One bootstrap-PF step of every θ's filter with always-resample
        (keeps the evidence estimator unbiased)."""
        xs = _gather_rows(xs, _systematic_rows(gen, lw))
        xs = torch.func.vmap(lambda x_row, th: torch.func.vmap(
            lambda x: model.step_sample(gen, x, t, th), **rand)(x_row), **rand)(xs, thetas)
        lw_new = obs_lp(xs, thetas, t)
        return xs, lw_new, _lme(lw_new)

    def pf_until(thetas, t_now):
        """A fresh filter for every θ over obs[0..t_now]: Ẑ_{t_now}(θ)."""
        xs, lw, lz = pf_init(thetas)
        for t in range(1, t_now + 1):
            xs, lw, incr = pf_step(xs, lw, thetas, t)
            lz = lz + incr
        return xs, lw, lz

    v_prior_logpdf = torch.func.vmap(model.prior_logpdf)

    def rejuvenate(thetas, xs, lws, lzs, t_now):
        """PMMH move for every θ particle (after an outer resample)."""
        leaves, treedef = tree_flatten(thetas)
        new_leaves = []
        for leaf in leaves:
            # adaptive RW proposal: scale per leaf from the population std
            std = torch.std(leaf, 0, correction=0, keepdim=True) + 1e-6
            new_leaves.append(leaf + rw_scale * std * torch.randn(
                leaf.shape, generator=gen, device=dev))
        thetas_prop = tree_unflatten(treedef, new_leaves)
        xs_p, lw_p, lz_p = pf_until(thetas_prop, t_now)
        log_a = (lz_p + v_prior_logpdf(thetas_prop)) - (lzs + v_prior_logpdf(thetas))
        log_a = torch.where(torch.isnan(log_a), -torch.inf, log_a)
        accept = torch.log(torch.rand((n_theta,), generator=gen, device=dev)) < log_a

        def sel(a, b):
            return torch.where(accept.reshape((n_theta,) + (1,) * (b.dim() - 1)), b, a)

        thetas = tree_unflatten(treedef, [sel(a, b) for a, b in zip(leaves, new_leaves)])
        return (thetas, sel(xs, xs_p), sel(lws, lw_p), sel(lzs, lz_p),
                torch.mean(accept.to(torch.float32)))

    thetas = torch.func.vmap(lambda _: model.prior_sample(gen), **rand)(
        torch.empty(n_theta, device=dev))
    xs, lws, lzs = pf_init(thetas)
    outer_lw = lzs                        # outer weight = running evidence
    log_evid = _lme(lzs)
    acc_s = torch.zeros((), device=dev)
    acc_n = 0
    rejuvenations = [False]
    for t in range(1, T):
        # advance every θ's inner filter one step
        xs, lws, incr = pf_step(xs, lws, thetas, t)
        lzs = lzs + incr
        # outer evidence increment: weighted mean of per-θ increments
        norm = torch.softmax(outer_lw, 0)
        m = torch.max(incr)
        log_evid = log_evid + torch.log(torch.clamp(
            torch.sum(norm * torch.exp(incr - m)), min=1e-38)) + m
        outer_lw = outer_lw + incr
        # outer ESS check -> resample + PMMH rejuvenation
        lw_n = outer_lw - torch.logsumexp(outer_lw, 0)
        ess = torch.exp(-torch.logsumexp(2.0 * lw_n, 0))
        do_rej = host_any(ess < ess_threshold * n_theta, "smc2")
        rejuvenations.append(do_rej)
        if do_rej:
            anc = systematic_resample(gen, outer_lw).long()
            thetas, xs, lws, lzs, a = rejuvenate(
                _take(thetas, anc), xs[anc], lws[anc], lzs[anc], t)
            outer_lw = torch.zeros_like(outer_lw)
            acc_s = acc_s + a
            acc_n += 1
    return SMC2Result(thetas, outer_lw, log_evid,
                      torch.tensor(rejuvenations), acc_s / max(acc_n, 1))
