"""Stochastic variational inference (ADVI) over the trace representation —
counterpart of ``cpprob_tpu/inference/svi.py``.

Guides (unconstrained space, constrained via ``FlatModel``'s bijections):

- ``meanfield``: diagonal normal — O(dim) params, axis-aligned posterior.
- ``fullrank``: multivariate normal with a dense Cholesky factor
  (Kucukelbir et al. 2017's full-rank ADVI) — captures posterior
  correlations the mean-field family cannot.

ELBO by the reparameterization trick with ``n_mc`` samples a step (the
log-joint under ``torch.func.vmap``), entropy in closed form, and
``torch.optim.Adam`` with every gradient zeroed, not unset, so a step is
optax's.  A step queues its work without waiting on the host: the losses
stay on the device, stacked at the end.

``init_loc`` warm-starts the variational mean — e.g. from a trained CSIS
proposal's posterior-mean estimate.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributions.base import to_device
from .potential import FlatModel, flatten_model
from .sis import _generator

__all__ = ["SVIResult", "svi"]

_HALF_LOG_2PI_E = 0.5 * (1.0 + math.log(2.0 * math.pi))


class SVIResult(NamedTuple):
    loc: torch.Tensor                          # (dim,) variational mean
    log_scale: torch.Tensor                    # (dim,) diag log-scales
    losses: torch.Tensor                       # (steps,) negative ELBO trace
    flat: FlatModel
    scale_tril: Optional[torch.Tensor] = None  # (dim, dim) full-rank factor

    def _draw_unconstrained(self, key, n: int):
        """``key``: a seed (a generator on ``loc``'s device) or a generator."""
        gen = _generator(key, self.loc.device)
        eps = torch.randn((n, self.loc.shape[0]), generator=gen, device=self.loc.device)
        if self.scale_tril is not None:
            return self.loc + eps @ self.scale_tril.T
        return self.loc + torch.exp(self.log_scale) * eps

    def sample(self, key, n: int):
        """Posterior samples: dict addr -> (n, ...) on the support."""
        return torch.func.vmap(self.flat.constrain)(self._draw_unconstrained(key, n))

    def mean(self, key, name: str, n: int = 4000):
        return torch.mean(self.sample(key, n)[name], 0)

    def covariance_unconstrained(self):
        """Cov of q in unconstrained space (exact, from the parameters)."""
        if self.scale_tril is not None:
            return self.scale_tril @ self.scale_tril.T
        return torch.diag(torch.exp(2.0 * self.log_scale))


def _tril_unpack(flat_tril, dim):
    """(dim*(dim+1)//2,) -> lower-triangular with softplus-positive diag."""
    rows, cols = torch.tril_indices(dim, dim, device=flat_tril.device)
    L = torch.zeros((dim, dim), dtype=flat_tril.dtype,
                    device=flat_tril.device).index_put((rows, cols), flat_tril)
    diag = F.softplus(torch.diagonal(L)) + 1e-6
    return L - torch.diag(torch.diagonal(L)) + torch.diag(diag)


def make_neg_elbo(flat: FlatModel, guide: str):
    """``neg_elbo(params, eps)``: the negative ELBO at the standard-normal
    draws ``eps`` (n_mc, dim); ``params`` is ``(loc, log_scale)``
    (meanfield) or ``(loc, flat_tril)`` (fullrank)."""
    dim = flat.dim
    v_log_joint = torch.func.vmap(flat.log_joint)
    if guide == "fullrank":
        def neg_elbo(params, eps):
            loc, flat_tril = params
            L = _tril_unpack(flat_tril, dim)
            logp = v_log_joint(loc + eps @ L.T)
            entropy = torch.sum(torch.log(torch.diagonal(L))) + dim * _HALF_LOG_2PI_E
            return -(torch.mean(logp) + entropy)
    else:
        def neg_elbo(params, eps):
            loc, log_scale = params
            logp = v_log_joint(loc + torch.exp(log_scale) * eps)
            entropy = torch.sum(log_scale) + dim * _HALF_LOG_2PI_E
            return -(torch.mean(logp) + entropy)
    return neg_elbo


def init_params(flat: FlatModel, guide: str, loc0: torch.Tensor):
    """The guide's initial parameters: ``loc0``, and log-scales of -1 or a
    Cholesky factor with softplus^{-1}(e^{-1}) on its diagonal."""
    dim, dev = flat.dim, loc0.device
    if guide == "fullrank":
        diag_slots = torch.cumsum(torch.arange(1, dim + 1, device=dev), 0) - 1
        on_diag = torch.zeros((dim * (dim + 1) // 2,), dtype=torch.bool,
                              device=dev).index_fill(0, diag_slots, True)
        inv_softplus = torch.log(torch.expm1(torch.exp(torch.full((), -1.0, device=dev))))
        return loc0, torch.where(on_diag, inv_softplus, 0.0)
    return loc0, torch.full((dim,), -1.0, device=dev)


def svi(
    model: Callable,
    args: Tuple,
    key,
    *,
    guide: str = "meanfield",
    steps: int = 2000,
    n_mc: int = 8,
    learning_rate: float = 0.05,
    flat: Optional[FlatModel] = None,
    init_loc=None,
    device="cuda",
) -> SVIResult:
    """``key``: a seed or a generator (the initial position and every
    step's draws); ``device`` is where it runs (``flat``'s, when given)."""
    if guide not in ("meanfield", "fullrank"):
        raise ValueError(f"unknown guide {guide!r}: use 'meanfield' or "
                         "'fullrank'")
    flat = flat or flatten_model(model, args, device)
    dim, dev = flat.dim, flat.device
    gen = _generator(key, dev)
    neg_elbo = make_neg_elbo(flat, guide)
    if init_loc is not None:
        loc0 = to_device(init_loc, dev, torch.float32).reshape(dim)
    else:
        loc0 = flat.initial_position(gen)
    params = [p.detach().clone().requires_grad_() for p in init_params(flat, guide, loc0)]
    for p in params:
        p.grad = torch.zeros_like(p)
    opt = torch.optim.Adam(params, lr=learning_rate)
    losses = []
    for _ in range(steps):
        eps = torch.randn((n_mc, dim), generator=gen, device=dev)
        loss = neg_elbo(params, eps)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses) if losses else torch.zeros((0,), device=dev)
    loc, second = (p.detach() for p in params)
    if guide == "fullrank":
        L = _tril_unpack(second, dim)
        return SVIResult(loc, torch.log(torch.diagonal(L)), losses, flat, scale_tril=L)
    return SVIResult(loc, second, losses, flat)
