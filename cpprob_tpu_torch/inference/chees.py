"""ChEES-HMC: cross-chain adaptive trajectory lengths (Hoffman, Radul &
Sountsov 2021) — counterpart of ``cpprob_tpu/inference/chees.py``.

The jittered-HMC kernel (:mod:`cpprob_tpu_torch.inference.hmc`) leaves the
mean trajectory length as a hyperparameter; ChEES tunes it by gradient
ascent on the Change in the Estimator of the Expected Squared jump
distance:

    g ∝ E_chains[ a · (||z'-z̄'||² - ||z-z̄||²) · ((z'-z̄')·p') ]

where a is the acceptance probability and the means are across the chains.
All chains run the same ``max_leapfrog`` steps with a masked readout at
``ceil(halton(i) · T / eps)``, so the adaptation never breaks lockstep;
the readout step, the step size and log T stay on the device, and log T
moves by a hand-written Adam step (the reference's).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..distributions.base import to_device
from .hmc import (
    HMCResult,
    _dual_averaging_init,
    _dual_averaging_update,
    _welford_init,
    _welford_inv_mass,
    _welford_update,
    finish,
    leapfrog_readout,
    metropolis,
)
from .potential import FlatModel, batched_grad, flatten_model, initial_positions
from .sis import _generator

__all__ = ["chees_hmc"]


def _halton(i, base=2):
    """Low-discrepancy jitter sequence (float32 in (0,1)): the 16-digit
    radical inverse of the integer tensor ``i`` in ``base``."""
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.tensor(1.0 / base, dtype=torch.float32, device=i.device)
    ii = i
    for _ in range(16):
        result = result + f * (ii % base).to(torch.float32)
        ii = ii // base
        f = f / base
    return torch.clamp(result, 1e-3, 1.0)


def chees_draws(generator: torch.Generator, n_chains: int, dim: int):
    """One transition's draws: standard-normal momenta (n_chains, dim) and
    the accept uniforms (n_chains,)."""
    dev = generator.device
    return (torch.randn((n_chains, dim), generator=generator, device=dev),
            torch.rand((n_chains,), generator=generator, device=dev))


def make_chees_kernel(potential: Callable, max_leapfrog: int):
    """One transition for a population of chains with the readout at step
    ``n_sel`` (a scalar tensor): ``kernel(generator, z, eps, inv_mass,
    n_sel, draws=None) -> (z', z_prop, p_prop, accept_p, U(z'))``."""
    vgrad = batched_grad(potential)

    def kernel(generator, z, eps, inv_mass, n_sel, draws=None):
        if draws is None:
            draws = chees_draws(generator, z.shape[0], z.shape[1])
        mom, uniform = draws
        p = mom / torch.sqrt(inv_mass)
        g, u0 = vgrad(z)
        z_new, p_new, u_new = leapfrog_readout(vgrad, z, p, g, eps, inv_mass,
                                               max_leapfrog, n_sel)
        z_out, accept_p, u_out, _ = metropolis(z, p, u0, z_new, p_new, u_new,
                                               inv_mass, uniform)
        return z_out, z_new, p_new, accept_p, u_out

    return kernel


def chees_grad(z, z_prop, p_prop, accept_p):
    """The ChEES criterion's gradient in log T, across the chains."""
    zb = torch.mean(z, 0)
    zpb = torch.mean(z_prop, 0)
    dz = torch.sum((z_prop - zpb) ** 2, 1) - torch.sum((z - zb) ** 2, 1)
    proj = torch.sum((z_prop - zpb) * p_prop, 1)
    w = accept_p
    return torch.sum(w * dz * proj) / torch.clamp(torch.sum(w), min=1e-6)


def _n_sel(u: float, log_T, eps, max_leapfrog: int):
    return torch.clamp(torch.ceil(u * torch.exp(log_T) / eps).to(torch.int32),
                       1, max_leapfrog)


def chees_hmc(
    model: Callable,
    args: Tuple,
    key,
    *,
    n_samples: int = 1000,
    n_warmup: int = 800,
    n_chains: int = 16,
    max_leapfrog: int = 64,
    initial_step_size: float = 0.1,
    initial_traj_length: float = 1.0,
    target_accept: float = 0.75,
    traj_learning_rate: float = 0.025,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
    device="cuda",
) -> HMCResult:
    """Adaptive HMC with ChEES trajectory-length tuning.  Returns the same
    result type as :func:`cpprob_tpu_torch.inference.hmc.hmc`."""
    flat = flat or flatten_model(model, args, device)
    gen = _generator(key, flat.device)
    dev = gen.device
    kernel = make_chees_kernel(flat.potential, max_leapfrog)
    # the jitter depends on the step index alone: one host computation
    halton = _halton(torch.arange(n_warmup + n_samples)).tolist()

    z = initial_positions(flat, gen, n_chains)
    da = _dual_averaging_init(to_device(float(initial_step_size), dev))
    welford = _welford_init(flat.dim, dev)
    log_T = torch.log(to_device(float(initial_traj_length), dev))
    m = torch.zeros((), device=dev)        # Adam's moments for log T
    v = torch.zeros((), device=dev)
    for i in range(n_warmup):
        eps = torch.exp(da["log_eps"])
        n_sel = _n_sel(halton[i], log_T, eps, max_leapfrog)
        z_new, z_prop, p_prop, acc, _ = kernel(gen, z, eps, _welford_inv_mass(welford), n_sel)
        g = chees_grad(z, z_prop, p_prop, acc)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        log_T = log_T + traj_learning_rate * m / (torch.sqrt(v) + 1e-8)
        log_T = torch.minimum(torch.maximum(log_T, torch.log(eps)),
                              torch.log(eps * max_leapfrog))
        da = _dual_averaging_update(da, torch.mean(acc), target_accept)
        welford = _welford_update(welford, z_new)
        z = z_new
    eps = torch.exp(da["log_eps_bar"])
    inv_mass = _welford_inv_mass(welford)
    zs, accs, pes = [], [], []
    for i in range(n_samples):
        n_sel = _n_sel(halton[i + n_warmup], log_T, eps, max_leapfrog)
        z, _, _, acc, pe = kernel(gen, z, eps, inv_mass, n_sel)
        zs.append(z)
        accs.append(acc)
        pes.append(pe)
    return finish(flat, zs, accs, pes, eps, inv_mass)
