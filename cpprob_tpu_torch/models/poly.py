"""Polynomial / linear regression models — counterpart of
``cpprob_tpu/models/poly.py`` (reference ``include/models/poly_adjustment.hpp``).

Variable dataset size is a static maximum plus a 0/1 mask
(:func:`poly_adjustment_prior_gen`, the ``Mask`` path).
"""

from __future__ import annotations

import torch

from ..core import as_tensor, handlers, metaobserve, observe, predict, sample
from ..distributions import Normal, Poisson

__all__ = [
    "generate_polynomial",
    "eval_poly",
    "poly_adjustment",
    "linear_regression",
    "poly_adjustment_prior_gen",
]


def generate_polynomial(degree: int):
    """coef_i ~ N(0, 10) for i in 0..degree (``poly_adjustment.hpp:16-24``)."""
    return [
        sample(Normal(0.0, 10.0), addr=f"coef[{i}]") for i in range(degree + 1)
    ]


def eval_poly(poly, x):
    """Horner evaluation (``poly_adjustment.hpp:26-31``)."""
    x = as_tensor(x)
    acc = torch.zeros_like(x, dtype=torch.promote_types(x.dtype, torch.float32))
    for c in reversed(poly):
        acc = acc * x + c
    return acc


def poly_adjustment(points, degree: int = 1):
    """points: (N, 2) array of (x, y) pairs (``poly_adjustment.hpp:84-96``)."""
    points = as_tensor(points)
    poly = generate_polynomial(degree)
    for i in range(points.shape[0]):
        observe(
            Normal(eval_poly(poly, points[i, 0]), 1.0), points[i, 1],
            addr=f"y[{i}]",
        )
    for c in poly:
        predict(c, "Coefficient")
    return poly


def linear_regression(points):
    """a, b ~ N(0, 10); y ~ N(a x + b, 1) (``poly_adjustment.hpp:57-80``)."""
    points = as_tensor(points)
    a = sample(Normal(0.0, 10.0), addr="a")
    b = sample(Normal(0.0, 10.0), addr="b")
    for i in range(points.shape[0]):
        metaobserve(Normal(3.0, 1.0), points[i, 0], addr=f"x[{i}]")
        observe(Normal(a * points[i, 0] + b, 1.0), points[i, 1], addr=f"y[{i}]")
    predict(a, "a")
    predict(b, "b")
    return a, b


def poly_adjustment_prior_gen(degree: int = 1, max_points: int = 32):
    """Metaprior'd generator (``poly_adjustment_prior``): dataset size
    n ~ 1 + Poisson(10) (positive Poisson), x_i ~ N(0, 10), y_i ~ N(poly(x), 1).

    Static-shape formulation: always max_points sites, masked beyond n.
    Returns (poly coefs, xs, ys, mask).
    """
    n = 1 + sample(Poisson(10.0), addr="n_points", control=False)
    n = torch.clamp(n, max=max_points)
    poly = generate_polynomial(degree)
    xs, ys = [], []
    idx = torch.arange(max_points, device=n.device)
    for i in range(max_points):
        active = (idx[i] < n).to(torch.float32)
        with handlers.Mask(active):
            x = sample(Normal(0.0, 10.0), addr=f"x[{i}]", control=False)
            # In compile mode observes are simulated; in inference they weight.
            y = observe(
                Normal(eval_poly(poly, x), 1.0), as_tensor(0.0), addr=f"y[{i}]"
            )
        xs.append(x)
        ys.append(y)
    for c in poly:
        predict(c, "Coefficient")
    return poly, torch.stack(xs), torch.stack(ys), (idx < n)
