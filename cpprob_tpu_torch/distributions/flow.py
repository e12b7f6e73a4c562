"""Normalizing-flow distribution for proposal heads — counterpart of
``cpprob_tpu/distributions/flow.py``: a univariate location-scale
rational-quadratic-spline flow (Durkan et al., "Neural Spline Flows",
NeurIPS 2019) over a standard-normal base.

The monotone piecewise-rational map has an analytic forward, inverse and
Jacobian, so ``log_prob`` is exact and cheap, with no iterative inversion.
All operations are elementwise plus a K-wide compare and gather.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .base import Distribution, dist_dataclass, promote_to_result_dtype

__all__ = ["SplineFlow1D"]

_HALF_LOG_2PI = 0.9189385332046727
_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3


def _spline_params(w_logits, h_logits, d_raw, bound):
    """Normalize raw head outputs into knot positions and derivatives.

    Returns (xs, ys, ds): knots (..., K+1) in x and y over [-B, B], and
    derivatives (..., K+1) with boundary derivatives pinned to 1 so the
    spline continues smoothly into the identity tails."""
    K = w_logits.shape[-1]
    w = torch.softmax(w_logits, dim=-1)
    h = torch.softmax(h_logits, dim=-1)
    w = _MIN_BIN + (1.0 - _MIN_BIN * K) * w
    h = _MIN_BIN + (1.0 - _MIN_BIN * K) * h
    xs = torch.cat([torch.zeros_like(w[..., :1]), torch.cumsum(w, dim=-1)], dim=-1)
    ys = torch.cat([torch.zeros_like(h[..., :1]), torch.cumsum(h, dim=-1)], dim=-1)
    xs = 2.0 * bound * xs - bound
    ys = 2.0 * bound * ys - bound
    d_in = _MIN_DERIV + F.softplus(d_raw)
    ones = torch.ones_like(d_in[..., :1])
    ds = torch.cat([ones, d_in, ones], dim=-1)
    return xs, ys, ds


def _gather_bin(arr, idx):
    arr_b = arr.expand(idx.shape + arr.shape[-1:])
    return torch.gather(arr_b, -1, idx[..., None])[..., 0]


def _rqs(z, xs, ys, ds, inverse: bool):
    """Monotone rational-quadratic spline on [-B, B] (identity outside).
    Returns (out, log|d out/d in|)."""
    K = xs.shape[-1] - 1
    bound = xs[..., -1]
    inside = (z > -bound) & (z < bound)
    zc = torch.minimum(torch.maximum(z, -bound + 1e-6), bound - 1e-6)

    knots = ys if inverse else xs
    idx = torch.clamp(
        (zc[..., None] >= knots[..., :-1]).to(torch.int64).sum(-1) - 1, 0, K - 1)
    x0 = _gather_bin(xs, idx)
    x1 = _gather_bin(xs, idx + 1)
    y0 = _gather_bin(ys, idx)
    y1 = _gather_bin(ys, idx + 1)
    d0 = _gather_bin(ds, idx)
    d1 = _gather_bin(ds, idx + 1)
    dx = x1 - x0
    dy = y1 - y0
    s = dy / dx

    if not inverse:
        xi = (zc - x0) / dx
        xi1 = xi * (1.0 - xi)
        denom = s + (d1 + d0 - 2.0 * s) * xi1
        out = y0 + dy * (s * xi * xi + d0 * xi1) / denom
        deriv = (
            s * s * (d1 * xi * xi + 2.0 * s * xi1 + d0 * (1.0 - xi) ** 2)
            / (denom * denom)
        )
        logd = torch.log(deriv)
    else:
        # solve the quadratic a xi^2 + b xi + c = 0 for xi (Durkan et al. A.3)
        t = zc - y0
        a = dy * (s - d0) + t * (d1 + d0 - 2.0 * s)
        b = dy * d0 - t * (d1 + d0 - 2.0 * s)
        c = -s * t
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        xi = 2.0 * c / (-b - torch.sqrt(disc))
        xi = torch.clamp(xi, 0.0, 1.0)
        xi1 = xi * (1.0 - xi)
        denom = s + (d1 + d0 - 2.0 * s) * xi1
        out = x0 + xi * dx
        deriv = (
            s * s * (d1 * xi * xi + 2.0 * s * xi1 + d0 * (1.0 - xi) ** 2)
            / (denom * denom)
        )
        logd = -torch.log(deriv)

    out = torch.where(inside, out, z)
    logd = torch.where(inside, logd, 0.0)
    return out, logd


@dist_dataclass
class SplineFlow1D(Distribution):
    """x = loc + scale * f(z), z ~ N(0, 1), f a K-bin rational-quadratic
    spline on [-bound, bound] with identity tails.

    Head layout (CSIS kind ``"nsf"``): ``w_logits`` (..., K) bin widths,
    ``h_logits`` (..., K) heights, ``d_raw`` (..., K-1) interior derivatives,
    plus location and scale.  It computes in float32, or in float64 where a
    parameter is float64 (the reference: float32 always).
    """

    w_logits: torch.Tensor
    h_logits: torch.Tensor
    d_raw: torch.Tensor
    loc: torch.Tensor
    scale: torch.Tensor
    bound: float = dataclasses.field(default=4.0, metadata=dict(static=True))

    def _params(self):
        w, h, d, loc, scale = promote_to_result_dtype(
            self.w_logits, self.h_logits, self.d_raw, self.loc, self.scale)
        return (*_spline_params(w, h, d, self.bound), loc, scale)

    def sample(self, generator, sample_shape=()):
        xs, ys, ds, loc, scale = self._params()
        shape = tuple(sample_shape) + self.batch_shape
        z = torch.randn(shape, generator=generator, dtype=loc.dtype,
                        device=self._device_of(generator))
        x, _ = _rqs(z, xs, ys, ds, inverse=False)
        return loc + scale * x

    def log_prob(self, x):
        xs, ys, ds, loc, scale = self._params()
        u = (self._as(x, loc.dtype) - loc) / scale
        z, logd_inv = _rqs(u, xs, ys, ds, inverse=True)
        log_base = -0.5 * z * z - _HALF_LOG_2PI
        return log_base + logd_inv - torch.log(scale)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.w_logits.shape[:-1], self.loc.shape, self.scale.shape))
