"""Weighted empirical distributions — counterpart of
``cpprob_tpu/postprocess/empirical.py`` (the reference's
``empirical_distribution.hpp``: logsumexp-normalized weighted moments,
``:117-143``), computed on the population's device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["EmpiricalDistribution"]


@dataclasses.dataclass(frozen=True)
class EmpiricalDistribution:
    """Values + log-weights; moments use the max-shift logsumexp trick for
    stability at 10^7+ particles.

    ``values`` may be (n,) or (n, ...) — moments reduce over the particle
    axis 0 and broadcast over trailing event dims.
    """

    values: torch.Tensor
    log_weights: torch.Tensor  # (n,)

    def _norm_weights(self) -> torch.Tensor:
        w = torch.exp(self.log_weights - torch.logsumexp(self.log_weights, 0))
        extra = self.values.dim() - 1
        return w.reshape(w.shape + (1,) * extra) if extra > 0 else w

    def _float_values(self) -> torch.Tensor:
        return self.values.to(torch.promote_types(self.values.dtype, torch.float32))

    @property
    def mean(self) -> torch.Tensor:
        return torch.sum(self._norm_weights() * self._float_values(), 0)

    @property
    def variance(self) -> torch.Tensor:
        w = self._norm_weights()
        v = self._float_values()
        m = torch.sum(w * v, 0)
        return torch.sum(w * (v - m) ** 2, 0)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.variance)

    @property
    def ess(self) -> torch.Tensor:
        lw = self.log_weights - torch.logsumexp(self.log_weights, 0)
        return torch.exp(-torch.logsumexp(2.0 * lw, 0))

    # -- discrete-support utilities (reference: normalized table + MAP,
    #    stats_printer.hpp:42-79) --------------------------------------
    def distribution(self, num_values: int) -> torch.Tensor:
        """Normalized probability table over integer support {0..num_values-1}
        (values outside it count for none, as ``jax.nn.one_hot``).

        For (n, ...) values returns (..., num_values)."""
        w = self._norm_weights()
        support = torch.arange(num_values, device=self.values.device)
        onehot = (self.values.long()[..., None] == support).to(w.dtype)
        return torch.sum(w[..., None] * onehot, 0)

    def map_estimate(self, num_values: int) -> torch.Tensor:
        return torch.argmax(self.distribution(num_values), -1)
