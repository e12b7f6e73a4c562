"""Support bijections for gradient-based inference (HMC/NUTS/SVI) —
counterpart of ``cpprob_tpu/inference/transforms.py``: maps each
continuous latent site to unconstrained space with log-Jacobian
corrections.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..distributions import (
    Beta,
    Cauchy,
    Exponential,
    Gamma,
    HalfNormal,
    Laplace,
    LogNormal,
    MinMaxContinuous,
    MultivariateNormalDiag,
    MultivariateNormalFull,
    Normal,
    StudentT,
    Truncated,
    Uniform,
)
from ..distributions.base import to_device

__all__ = ["Transform", "IDENTITY", "biject_for"]


@dataclasses.dataclass(frozen=True)
class Transform:
    """z (unconstrained) -> x (support); ``log_det`` is d log|dx/dz|."""

    forward: Callable
    inverse: Callable
    log_det: Callable  # log |dx/dz| evaluated at z


IDENTITY = Transform(
    forward=lambda z: z,
    inverse=lambda x: x,
    log_det=lambda z: torch.zeros_like(torch.as_tensor(z), dtype=torch.float32),
)


def _positive() -> Transform:
    # x = exp(z)
    return Transform(
        forward=torch.exp,
        inverse=torch.log,
        log_det=lambda z: z,
    )


def _interval(low, high, device) -> Transform:
    # placed without a sync (``torch.as_tensor`` onto the card waits on it)
    low = to_device(low, device, torch.float32)
    high = to_device(high, device, torch.float32)
    width = high - low

    def fwd(z):
        return low + width * torch.sigmoid(z)

    def inv(x):
        p = torch.clamp((x - low) / width, 1e-6, 1.0 - 1e-6)
        return torch.log(p) - torch.log1p(-p)

    def ld(z):
        return torch.log(width) + F.logsigmoid(z) + F.logsigmoid(-z)

    return Transform(fwd, inv, ld)


def biject_for(dist) -> Optional[Transform]:
    """Transform whose image is the support of ``dist``; None for discrete or
    unsupported distributions (those sites cannot be HMC latents)."""
    if isinstance(dist, (Normal, Laplace, MultivariateNormalDiag,
                         MultivariateNormalFull, StudentT, Cauchy)):
        return IDENTITY
    if isinstance(dist, (Gamma, Exponential, LogNormal, HalfNormal)):
        return _positive()
    if isinstance(dist, Uniform):
        return _interval(dist.low, dist.high, dist.device)
    if isinstance(dist, Beta):
        return _interval(0.0, 1.0, dist.device)
    if isinstance(dist, MinMaxContinuous):
        return _interval(dist.low, dist.high, dist.device)
    if isinstance(dist, Truncated):
        return _interval(dist.low, dist.high, dist.device)
    return None
