"""Distributionally-robust (chi-square ball) loss reweighting — counterpart
of ``cpprob_tpu/inference/regularize.py`` (the reference's
``infcomp/nn/regularize.py``, Namkoong & Duchi's variance-regularized ERM;
wired into the loss through ``CSIS.compile(dro_rho=...)``).

Given per-trace losses l_i, finds the worst-case weights within the
chi-square divergence ball {w : w >= 0, sum w = 1, n/2 * ||w - 1/n||^2 <= rho}
and returns sum_i w_i l_i.  The maximizer is w_i ∝ relu(l_i - eta), found by
a fixed number of active-set iterations: no value is read back, so it never
waits on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["chi_square_weights", "dro_loss"]


def _weights(losses, mask, radius):
    m = torch.clamp(torch.sum(mask), min=1.0)
    mean_l = torch.sum(mask * losses) / m
    dev = mask * (losses - mean_l)
    norm = torch.sqrt(torch.sum(dev * dev)) + 1e-12
    return mask * (1.0 / m + radius * dev / norm)


def chi_square_weights(losses: torch.Tensor, rho: float, n_iters: int = 8) -> torch.Tensor:
    """Worst-case chi-square-ball weights for ``losses`` (shape (n,)).

    Unconstrained by non-negativity, w = 1/n + r (l - mean l)/||l - mean l||
    with r = sqrt(2 rho / n) (the variance-regularized objective mean(l) +
    r ||l - mean l||); ``n_iters`` active-set iterations clip it to the
    simplex (exact when nothing clips)."""
    radius = math.sqrt(2.0 * rho / losses.shape[0])
    mask = torch.ones_like(losses)
    for _ in range(n_iters):
        w = _weights(losses, mask, radius)
        mask = torch.where(w > 0, mask, torch.zeros_like(mask))
    w = torch.relu(_weights(losses, mask, radius))
    return w / torch.sum(w)


def dro_loss(losses: torch.Tensor, rho: float) -> torch.Tensor:
    """Robust objective: sup over the chi-square ball of E_w[l].  Gradients
    flow through ``losses`` only (the weights are constants, the
    Danskin-theorem estimator)."""
    w = chi_square_weights(losses.detach(), rho)
    return torch.sum(w * losses)
