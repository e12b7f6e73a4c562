"""Nested-structure flattening — the port's copy of
``cpprob_tpu/util/ndarray.py`` (numpy only; the port imports nothing of the
JAX package).  Counterpart of the reference's ``NDArray``
(``include/cpprob/ndarray.hpp``): dense tensor from arbitrarily nested
containers/tuples with ragged-shape zero padding (``ndarray.hpp:361-467``),
and of ``StateInfer``'s observation flattening ``detail::to_vec``
(``state.hpp:112-182``); and the port's :func:`to_host`, a tensor copied
back to a host array.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["to_ndarray", "flatten_nested", "to_host"]


def _max_shape(values: List[np.ndarray]) -> Tuple[int, ...]:
    rank = max(v.ndim for v in values)
    dims = [1] * rank
    for v in values:
        s = (1,) * (rank - v.ndim) + v.shape
        dims = [max(d, x) for d, x in zip(dims, s)]
    return tuple(dims)


def to_ndarray(value: Any) -> np.ndarray:
    """Nested lists/tuples/scalars/arrays -> one dense float array; ragged
    shapes zero-padded like the reference (``ndarray.hpp:361-467``)."""
    if isinstance(value, (int, float, np.number)):
        return np.asarray(float(value))
    if isinstance(value, np.ndarray):
        return value.astype(np.float32) if value.dtype != np.float64 else value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if hasattr(value, "__array__"):
        return np.asarray(value)
    if isinstance(value, (list, tuple)):
        subs = [to_ndarray(v) for v in value]
        if not subs:
            return np.zeros((0,), np.float32)
        shape = _max_shape(subs)
        out = np.zeros((len(subs),) + shape, np.float32)
        for i, s in enumerate(subs):
            s = np.asarray(s, np.float32)
            s = s.reshape((1,) * (len(shape) - s.ndim) + s.shape)
            slices = (i,) + tuple(slice(0, d) for d in s.shape)
            out[slices] = s
        return out
    raise TypeError(f"cannot convert {type(value).__name__} to ndarray")


def flatten_nested(value: Any) -> np.ndarray:
    """Flatten any nested structure to a 1-D float vector (``detail::to_vec``,
    ``state.hpp:112-182``) — the observation-vector builder."""
    return np.ravel(to_ndarray(value))


def to_host(x) -> np.ndarray:
    """``x`` (a tensor, or anything ``np.asarray`` takes) as a host array; a
    card's tensor is copied back, a sync."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
