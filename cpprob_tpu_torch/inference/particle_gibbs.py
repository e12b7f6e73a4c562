"""Particle Gibbs: conditional SMC (CSMC) with ancestor sampling —
counterpart of ``cpprob_tpu/inference/particle_gibbs.py``.

A Markov kernel on *trajectories* of a
:class:`~cpprob_tpu_torch.inference.smc.StateSpaceModel` whose invariant
distribution is the exact smoothing posterior p(z_{0:T} | y_{0:T})
(Andrieu, Doucet & Holenstein 2010; ancestor sampling per Lindsten, Jordan
& Schön 2014, PGAS).  Each sweep runs an SMC pass in which particle 0 is
clamped to the reference trajectory; ancestor sampling rejuvenates the
reference's genealogy so the kernel mixes even when N is small.
Multinomial resampling (inverse CDF of float64 weights) is used for the
free particles.

Time and the iterations are Python loops over the population's tensors;
nothing waits on the host (no host read).  The model's hooks take a
``torch.Generator`` on the population's device: its batched hooks where
it has them, else its per-particle hooks under ``torch.func.vmap``;
``step_logpdf`` (ancestor sampling) runs per particle under vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributions.base import to_device
from .potential import engine_device
from .resampling import _categorical
from .sis import _generator
from .smc import StateSpaceModel, _log_mean_exp, _obs_logpdf, _per_particle

__all__ = ["CSMCResult", "csmc_sweep", "particle_gibbs"]


class CSMCResult(NamedTuple):
    trajectory: torch.Tensor     # (T, ...) sampled smoothing trajectory
    log_evidence: torch.Tensor   # scalar CSMC log-Z estimate (biased; diagnostics)


def _draw(gen, log_w, n: int):
    """``n`` multinomial indices from unnormalized log-weights."""
    return _categorical(gen, torch.softmax(log_w.double(), 0), n).long()


def _set0(states, value):
    return torch.cat([value.to(states.dtype)[None], states[1:]])


def _csmc(model, observations, n, gen, reference, ancestor_sampling):
    T = observations.shape[0]
    if model.init_sample_batch is not None:
        states = model.init_sample_batch(gen, n)
    else:
        states = _per_particle(lambda g, _: model.init_sample(g), gen,
                               torch.empty(n, device=gen.device))
    states0 = _set0(states, reference[0])
    log_w = _obs_logpdf(model, states0, observations[0], 0)
    log_z = torch.zeros((), device=gen.device)
    states, hist_s, hist_a = states0, [], []
    for t in range(1, T):
        ref_t = reference[t]
        anc = _draw(gen, log_w, n)          # multinomial, free particles
        if ancestor_sampling:
            # a_t^0 ~ w_{t-1}^i * p(ref_t | z_{t-1}^i)
            # the reference state goes in batched: indexing with an unbatched
            # card scalar would read it back to the host
            trans_lp = torch.func.vmap(lambda r, s: model.step_logpdf(r, s, t))(
                ref_t.expand(states.shape[:1] + ref_t.shape), states)
            a0 = _draw(gen, log_w + trans_lp, 1)
        else:
            a0 = anc.new_zeros(1)
        anc = torch.cat([a0, anc[1:]])
        parents = states[anc]
        if model.step_sample_batch is not None:
            moved = model.step_sample_batch(gen, parents, t)
        else:
            moved = _per_particle(lambda g, s: model.step_sample(g, s, t), gen, parents)
        states = _set0(moved, ref_t)
        log_z = log_z + _log_mean_exp(log_w)
        log_w = _obs_logpdf(model, states, observations[t], t)
        hist_s.append(states)
        hist_a.append(anc)
    log_z = log_z + _log_mean_exp(log_w)
    # backward trajectory draw through the stored genealogy
    b = _draw(gen, log_w, 1)
    traj = []
    for s_t, a_t in zip(reversed(hist_s), reversed(hist_a)):
        traj.append(s_t.index_select(0, b))
        b = a_t.index_select(0, b)
    traj.append(states0.index_select(0, b))
    return CSMCResult(torch.cat(traj[::-1]), log_z)


def csmc_sweep(
    model: StateSpaceModel,
    observations,
    n_particles: int,
    key,
    reference,
    *,
    ancestor_sampling: bool = True,
    device="cuda",
) -> CSMCResult:
    """One conditional-SMC sweep: returns a fresh trajectory drawn from a
    kernel that leaves p(z_{0:T} | y_{0:T}) invariant given ``reference``
    (a (T, ...) trajectory, e.g. the previous sweep's output).

    ``ancestor_sampling=True`` draws a new ancestor for the clamped particle
    at every step, a_t^0 ~ w_{t-1}^i · p(ref_t | z_{t-1}^i), which breaks
    the reference's path degeneracy (Lindsten et al. 2014).  Requires
    ``model.step_logpdf``.  ``key``: a seed or a generator; the sweep runs
    on ``device``.
    """
    dev = engine_device(device)
    gen = _generator(key, dev)
    return _csmc(model, to_device(observations, dev), n_particles, gen,
                 to_device(reference, dev), ancestor_sampling)


def particle_gibbs(
    model: StateSpaceModel,
    observations,
    n_particles: int,
    n_iters: int,
    key,
    *,
    ancestor_sampling: bool = True,
    init_reference=None,
    burn_in: int = 0,
    jit: bool = True,
    device="cuda",
):
    """Particle-Gibbs chain: iterated CSMC sweeps, each conditioned on the
    previous sweep's trajectory.  Returns (T-major stacked) trajectories of
    shape (n_iters - burn_in, T, ...) distributed (asymptotically) as the
    smoothing posterior p(z_{0:T} | y_{0:T}), and each sweep's log-Z.
    The first reference is ``init_reference`` or a prior rollout.
    """
    dev = engine_device(device)
    gen = _generator(key, dev)
    observations = to_device(observations, dev)
    T = observations.shape[0]
    if init_reference is not None:
        reference = to_device(init_reference, dev)
    else:
        def rollout(g, _):
            z = model.init_sample(g)
            zs = [z]
            for t in range(1, T):
                z = model.step_sample(g, z, t)
                zs.append(z)
            return torch.stack(zs)

        reference = _per_particle(rollout, gen, torch.empty(1, device=dev))[0]
    trajs, log_zs = [], []
    for _ in range(n_iters):
        res = _csmc(model, observations, n_particles, gen, reference, ancestor_sampling)
        reference = res.trajectory
        trajs.append(res.trajectory)
        log_zs.append(res.log_evidence)
    trajs, log_zs = torch.stack(trajs), torch.stack(log_zs)
    return trajs[burn_in:], log_zs[burn_in:]
