"""Compensated (Neumaier) floating-point accumulation — counterpart of
``cpprob_tpu/util/numerics.py``.

A sequential float32 running sum over many chunks loses ~log10(n_chunks)
digits; carrying an explicit compensation term beside each running sum
keeps the error O(eps) independent of the chunk count.  Used by
:func:`cpprob_tpu_torch.inference.sis.sis_streaming` for its streaming
log-weight/moment merge.
"""

from typing import NamedTuple

import torch

__all__ = ["CompSum", "comp_zero", "comp_add", "comp_scale", "comp_value"]


class CompSum(NamedTuple):
    """A compensated running sum: ``value`` + ``comp`` (error term)."""

    value: torch.Tensor
    comp: torch.Tensor


def comp_zero(like) -> CompSum:
    z = torch.zeros_like(torch.as_tensor(like))
    return CompSum(z, z)


def _two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def comp_add(acc: CompSum, x) -> CompSum:
    """Neumaier-compensated ``acc + x``."""
    x = torch.as_tensor(x, dtype=acc.value.dtype, device=acc.value.device)
    s, err = _two_sum(acc.value, x)
    return CompSum(s, acc.comp + err)


def comp_scale(acc: CompSum, a) -> CompSum:
    """Scale both the sum and its compensation by ``a`` (a <= 1 rescale, as
    in a max-shift logsumexp merge)."""
    return CompSum(acc.value * a, acc.comp * a)


def comp_value(acc: CompSum) -> torch.Tensor:
    """Collapse to the best available estimate of the true sum."""
    return acc.value + acc.comp
