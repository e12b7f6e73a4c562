"""HMC with cross-chain adaptation — counterpart of
``cpprob_tpu/inference/hmc.py``, a gradient-based engine over the trace
representation.

- Chains are the batch axis: the gradient of the potential is
  ``torch.func.vmap(torch.func.grad(potential))`` over all chains at once,
  and every transition advances all chains in lockstep.  Chains are the
  cheap axis on a GPU: a call's cost is the host's, a few ms a gradient
  whatever the chain count.
- Trajectory lengths are jittered (uniform over [1, L]) and all ``L``
  leapfrog steps run; the proposal is read out at the chosen step by a
  masked select, as in the reference.
- A gradient is computed once and reused: the gradient at the end of one
  leapfrog step is the one the next step starts from, so a transition
  takes ``L + 1`` gradient evaluations where the reference's ``scan``
  writes ``2 L``, and the potential at the proposal comes with its
  gradient.
- Warmup: dual-averaging step size (target accept 0.8) and a Welford
  diagonal mass, both on statistics averaged across the chains of this
  one process.

A call queues its work without waiting on the host: the step size, the
mass and the acceptance statistics stay on the device.  ``key`` is an
integer seed or a ``torch.Generator``; ``jit`` keeps its name and
compiles nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..distributions.base import to_device
from .potential import FlatModel, batched_grad, flatten_model, initial_positions
from .sis import _generator

__all__ = ["HMCResult", "hmc", "make_hmc_kernel"]


class HMCResult(NamedTuple):
    positions: torch.Tensor         # (n_chains, n_samples, dim) unconstrained
    samples: dict                   # addr -> (n_chains, n_samples, ...) constrained
    accept_rate: torch.Tensor       # (n_chains,)
    step_size: torch.Tensor         # scalar, adapted
    inv_mass: torch.Tensor          # (dim,) adapted diagonal inverse mass
    potential_energy: torch.Tensor  # (n_chains, n_samples)


def hmc_draws(generator: torch.Generator, n_chains: int, dim: int, max_leapfrog: int,
              jitter: bool = True):
    """One transition's draws: standard-normal momenta (n_chains, dim), the
    readout step in [1, max_leapfrog] (n_chains,), the accept uniforms
    (n_chains,)."""
    dev = generator.device
    mom = torch.randn((n_chains, dim), generator=generator, device=dev)
    if jitter:
        n_sel = torch.randint(1, max_leapfrog + 1, (n_chains,), generator=generator, device=dev)
    else:
        n_sel = torch.full((n_chains,), max_leapfrog, device=dev)
    u = torch.rand((n_chains,), generator=generator, device=dev)
    return mom, n_sel, u


def leapfrog_readout(vgrad, z, p, g, eps, inv_mass, n_steps: int, n_sel=None):
    """``n_steps`` leapfrog steps from (z, p) with the gradient ``g`` at z,
    each starting from the gradient the last one ended with; returns the
    state after step ``n_sel`` (per chain, a tensor or a scalar tensor;
    None: the last step): (z, p, U)."""
    z_keep, p_keep, u_keep = z, p, None
    for i in range(n_steps):
        p_half = p - 0.5 * eps * g
        z = z + eps * inv_mass * p_half
        g, u = vgrad(z)
        p = p_half - 0.5 * eps * g
        if n_sel is None:
            z_keep, p_keep, u_keep = z, p, u
            continue
        take = n_sel == i + 1
        z_keep = torch.where(take[..., None], z, z_keep)
        p_keep = torch.where(take[..., None], p, p_keep)
        u_keep = u if u_keep is None else torch.where(take, u, u_keep)
    return z_keep, p_keep, u_keep


def metropolis(z, p, u0, z_new, p_new, u_new, inv_mass, uniform):
    """The accept step on H = U + p·M⁻¹p/2: (z', accept probability, U(z'))
    and the accept flags."""
    h0 = u0 + 0.5 * torch.sum(inv_mass * p * p, -1)
    h1 = u_new + 0.5 * torch.sum(inv_mass * p_new * p_new, -1)
    log_accept = torch.clamp(h0 - h1, max=0.0)
    log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
    accept = torch.log(uniform) < log_accept
    z_out = torch.where(accept[:, None], z_new, z)
    return z_out, torch.exp(log_accept), torch.where(accept, u_new, u0), accept


def make_hmc_kernel(
    potential: Callable,
    max_leapfrog: int,
    jitter: bool = True,
):
    """One transition for a population of chains: ``kernel(generator, z
    (n_chains, dim), eps, inv_mass, draws=None) -> (z', accept_p, U(z'))``.
    Jittered trajectory: all ``max_leapfrog`` steps run; the proposal is
    read out at a uniformly chosen step by a masked select.  ``draws``
    (:func:`hmc_draws`' tuple) pins the random numbers."""
    vgrad = batched_grad(potential)

    def kernel(generator, z, eps, inv_mass, draws=None):
        if draws is None:
            draws = hmc_draws(generator, z.shape[0], z.shape[1], max_leapfrog, jitter)
        mom, n_sel, uniform = draws
        p = mom / torch.sqrt(inv_mass)
        g, u0 = vgrad(z)
        z_new, p_new, u_new = leapfrog_readout(vgrad, z, p, g, eps, inv_mass,
                                               max_leapfrog, n_sel)
        z_out, accept_p, u_out, _ = metropolis(z, p, u0, z_new, p_new, u_new,
                                               inv_mass, uniform)
        return z_out, accept_p, u_out

    return kernel


def _dual_averaging_init(eps0):
    """``eps0``: a number or a scalar tensor (its device is the state's)."""
    eps0 = torch.as_tensor(eps0, dtype=torch.float32)
    log_eps = torch.log(eps0)
    return {
        "log_eps": log_eps,
        "log_eps_bar": log_eps,
        "h_bar": torch.zeros_like(log_eps),
        "mu": torch.log(10.0 * eps0),
        "t": torch.zeros_like(log_eps),
    }


def _dual_averaging_update(state, accept_prob, target=0.8):
    t = state["t"] + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h_bar = (1.0 - 1.0 / (t + t0)) * state["h_bar"] + (
        target - accept_prob
    ) / (t + t0)
    log_eps = state["mu"] - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state["log_eps_bar"]
    return {
        "log_eps": log_eps,
        "log_eps_bar": log_eps_bar,
        "h_bar": h_bar,
        "mu": state["mu"],
        "t": t,
    }


def _welford_init(dim: int, device):
    """(mean, M2, count) of the running cross-chain mean position."""
    return (torch.zeros((dim,), device=device), torch.zeros((dim,), device=device),
            torch.zeros((), device=device))


def _welford_update(state, z):
    """One Welford step on the mean over chains of ``z`` (n_chains, dim)."""
    w_mean, w_m2, w_n = state
    zm = torch.mean(z, 0)
    delta = zm - w_mean
    w_n = w_n + 1.0
    w_mean = w_mean + delta / w_n
    w_m2 = w_m2 + delta * (zm - w_mean)
    return w_mean, w_m2, w_n


def _welford_inv_mass(state):
    """The diagonal inverse mass: the Welford variance once more than 10
    steps are in, floored at 1e-3; ones before."""
    _, w_m2, w_n = state
    return torch.where(
        w_n > 10.0,
        torch.clamp(w_m2 / torch.clamp(w_n - 1.0, min=1.0), min=1e-3),
        torch.ones_like(w_m2),
    )


def adaptive_run(vkernel, flat: FlatModel, generator, n_chains, n_warmup, n_samples,
                 initial_step_size, target_accept) -> HMCResult:
    """HMC's and NUTS's run: prior draws, warmup (dual averaging on the mean
    accept statistic, Welford mass over the chains), then ``n_samples``
    transitions at the final step size and mass.  ``vkernel(generator, z,
    eps, inv_mass) -> (z', accept, U)``."""
    dev = generator.device
    z = initial_positions(flat, generator, n_chains)
    da = _dual_averaging_init(to_device(float(initial_step_size), dev))
    welford = _welford_init(flat.dim, dev)
    for _ in range(n_warmup):
        eps = torch.exp(da["log_eps"])
        z, acc, _ = vkernel(generator, z, eps, _welford_inv_mass(welford))
        da = _dual_averaging_update(da, torch.mean(acc), target_accept)
        welford = _welford_update(welford, z)
    eps = torch.exp(da["log_eps_bar"])
    inv_mass = _welford_inv_mass(welford)
    zs, accs, pes = [], [], []
    for _ in range(n_samples):
        z, acc, pe = vkernel(generator, z, eps, inv_mass)
        zs.append(z)
        accs.append(acc)
        pes.append(pe)
    return finish(flat, zs, accs, pes, eps, inv_mass)


def finish(flat: FlatModel, zs, accs, pes, eps, inv_mass) -> HMCResult:
    """Stack the sampling phase's (n_chains, ...) per-step lists chain-major
    and constrain the positions."""
    zs = torch.stack(zs, 1)
    accs = torch.mean(torch.stack(accs, 1), 1)
    pes = torch.stack(pes, 1)
    constrained = torch.func.vmap(torch.func.vmap(flat.constrain))(zs)
    return HMCResult(zs, constrained, accs, eps, inv_mass, pes)


def hmc(
    model: Callable,
    args: Tuple,
    key,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_chains: int = 4,
    max_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    jitter: bool = True,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
    device="cuda",
) -> HMCResult:
    """Run adaptive HMC; returns constrained samples per latent address.
    ``device`` is where the chains run (``flat``'s, when given)."""
    flat = flat or flatten_model(model, args, device)
    kernel = make_hmc_kernel(flat.potential, max_leapfrog, jitter)
    return adaptive_run(kernel, flat, _generator(key, flat.device), n_chains, n_warmup,
                        n_samples, initial_step_size, target_accept)
