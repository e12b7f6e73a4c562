"""Adaptive tempered SMC sampler for arbitrary models (static latents) —
counterpart of ``cpprob_tpu/inference/smc_sampler.py``.

SMC moves a particle population from the prior to the posterior through a
likelihood-tempered path

    pi_beta(z) ∝ p(z) · L(z)^beta,   0 = beta_0 < ... < beta_K = 1,

with (1) adaptive tempering — the next beta is chosen by a 20-step
bisection on the device so the incremental weights keep a target
conditional ESS, (2) systematic resampling, and (3) HMC rejuvenation moves
targeting pi_beta (one gradient evaluation a leapfrog step: each starts
from the gradient the last one ended with).

The reference's ``lax.while_loop`` over stages is a Python loop here.
Whether it goes on (beta < 1) is **one host read a stage**, of one flag,
counted in ``distributions.base.HOST_READS["smc_sampler"]``; nothing else
in a stage waits on the host.  The particles run under
``torch.func.vmap``; ``key`` is a seed or a generator; ``jit`` compiles
nothing.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core import handlers
from ..distributions.base import host_any
from .hmc import leapfrog_readout, metropolis
from .potential import (
    FlatModel,
    batched_grad,
    constrain_with_jacobian,
    flatten_model,
    initial_positions,
)
from .resampling import systematic_resample
from .sis import _generator, _nested

__all__ = ["TemperedSMCResult", "smc_sampler"]


class TemperedSMCResult(NamedTuple):
    positions: torch.Tensor      # (N, dim) unconstrained posterior particles
    samples: dict                # addr -> (N, ...) constrained
    log_evidence: torch.Tensor   # scalar
    n_stages: torch.Tensor       # temperature epochs used
    betas_used: torch.Tensor     # (max_stages,) padded with 1.0
    accept_rate: torch.Tensor    # mean HMC-move acceptance over the run


def _split_log_joint(model: Callable, args: Tuple, flat: FlatModel):
    """log prior density and log likelihood as separate functions of flat z.

    Prior = sum of sample-site log-probs (+ transform Jacobians);
    likelihood = sum of observe/factor contributions.  Both run the model
    under a ``Seed`` on ``flat``'s device (the device rule)."""
    gen = torch.Generator(device=flat.device)   # never drawn from

    def log_prior(z):
        values, jac = constrain_with_jacobian(flat.latents, z)
        tr = handlers.TraceHandler()
        with _nested([handlers.Substitute(values), handlers.Seed(gen), tr]):
            model(*args)
        total = jac
        for site in tr.trace.values():
            if site["type"] == "sample" and not site["is_observed"]:
                total = total + torch.sum(site["dist"].log_prob(site["value"]))
        return total

    def log_lik(z):
        values, _ = constrain_with_jacobian(flat.latents, z)
        lw = handlers.LogWeight()
        with _nested([handlers.Substitute(values), handlers.Seed(gen), lw]):
            model(*args)
        return lw.log_weight

    return log_prior, log_lik


def _next_beta(beta, loglik, target_cess: float):
    """Bisect (20 steps, on the device) for beta' in (beta, 1] with
    conditional ESS ~ ``target_cess``; 1 when the full step keeps it."""
    n = loglik.shape[0]

    def cess(b):
        lw = (b - beta) * loglik
        lw = lw - torch.max(lw)
        w = torch.exp(lw)
        return (torch.sum(w) ** 2) / (n * torch.sum(w * w))

    one = torch.ones_like(beta)
    lo, hi = beta, one
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        ok = cess(mid) >= target_cess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(cess(one) >= target_cess, one, lo)


def smc_sampler(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key,
    *,
    target_cess: float = 0.9,
    n_hmc_moves: int = 2,
    hmc_step_size: float = 0.2,
    hmc_leapfrogs: int = 8,
    max_stages: int = 50,
    waste_free: bool = False,
    chain_length: int = 8,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
    device="cuda",
) -> TemperedSMCResult:
    """Adaptive likelihood-tempered SMC from prior to posterior.

    ``waste_free=True`` switches the move step to waste-free SMC (Dau &
    Chopin, JRSS-B 2022): ``n_particles // chain_length`` ancestors are
    resampled and each runs a length-``chain_length`` HMC chain whose
    **every** state (including the start) enters the next population.
    Requires ``n_particles % chain_length == 0``.
    """
    if waste_free:
        if chain_length < 2:
            raise ValueError("waste_free needs chain_length >= 2")
        if n_particles % chain_length != 0:
            raise ValueError(
                "n_particles must be divisible by chain_length "
                f"({n_particles} % {chain_length} != 0)"
            )
    n_roots = n_particles // chain_length if waste_free else n_particles
    flat = flat or flatten_model(model, args, device)
    dim = flat.dim
    gen = _generator(key, flat.device)
    dev = gen.device
    log_prior, log_lik = _split_log_joint(model, args, flat)
    v_log_lik = torch.func.vmap(log_lik)
    beta_box = [None]     # the stage's beta, read by the potential under vmap
    vgrad = batched_grad(lambda z: -(log_prior(z) + beta_box[0] * log_lik(z)))

    def hmc_move(z, eps):
        """One HMC move (unit mass) of every row of ``z`` targeting
        pi_beta: (z', accept probability)."""
        p = torch.randn(z.shape, generator=gen, device=dev)
        g, u0 = vgrad(z)
        z_n, p_n, u_n = leapfrog_readout(vgrad, z, p, g, eps, 1.0, hmc_leapfrogs)
        uniform = torch.rand(z.shape[:1], generator=gen, device=dev)
        z_out, accept_p, _, _ = metropolis(z, p, u0, z_n, p_n, u_n, 1.0, uniform)
        return z_out, accept_p

    zs = initial_positions(flat, gen, n_particles)
    beta = torch.zeros((), device=dev)
    log_z = torch.zeros((), device=dev)
    betas = torch.ones((max_stages,), device=dev)
    acc_sum = torch.zeros((), device=dev)
    stage = 0
    while stage < max_stages and (stage == 0 or host_any(beta < 1.0, "smc_sampler")):
        loglik = v_log_lik(zs)
        beta_new = _next_beta(beta, loglik, target_cess)
        lw = (beta_new - beta) * loglik
        log_z = log_z + torch.logsumexp(lw, 0) - math.log(n_particles)
        beta_box[0] = beta_new
        anc = systematic_resample(gen, lw, n_out=n_roots).long()
        z = zs[anc]
        if waste_free:
            # every chain state (root included) enters the next population
            chain, a_sum = [z], torch.zeros((n_roots,), device=dev)
            for _ in range(chain_length - 1):
                z, a = hmc_move(z, hmc_step_size)
                chain.append(z)
                a_sum = a_sum + a
            zs = torch.stack(chain, 1).reshape(n_particles, dim)
            accs = a_sum / (chain_length - 1)
        else:
            a_sum = torch.zeros((n_roots,), device=dev)
            for _ in range(n_hmc_moves):
                z, a = hmc_move(z, hmc_step_size)
                a_sum = a_sum + a
            zs, accs = z, a_sum / n_hmc_moves
        betas[stage] = beta_new
        acc_sum = acc_sum + torch.mean(accs)
        beta = beta_new
        stage += 1
    samples = torch.func.vmap(flat.constrain)(zs)
    return TemperedSMCResult(zs, samples, log_z, torch.tensor(stage),
                             betas, acc_sum / max(stage, 1))
