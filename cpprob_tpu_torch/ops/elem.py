"""The elementwise namespace of user physics (``step_elem``).

A ``step_elem`` or a guided density written against this namespace runs
twice over: on torch tensors in the plain versions (here each name is the
torch function), and inside a generated kernel, where each ``elem.<name>``
call becomes CUDA C++ (:mod:`.render`: precise ``expf``, ``logf``,
``sinf``, ``cosf``, ``tanhf``; ``__fsqrt_rn``; ``?:``, ``fminf``,
``fmaxf``).  See :mod:`.render` for the whole contract.

A number may stand for either value operand of ``where``, ``minimum``
and ``maximum``; it is broadcast on the device, never copied from the
host.
"""

from __future__ import annotations

import torch

__all__ = ["NAMES", "exp", "log", "sqrt", "sin", "cos", "tanh", "where",
           "minimum", "maximum"]

NAMES = ("exp", "log", "sqrt", "sin", "cos", "tanh", "where", "minimum",
         "maximum")

exp = torch.exp
log = torch.log
sqrt = torch.sqrt
sin = torch.sin
cos = torch.cos
tanh = torch.tanh
where = torch.where     # takes numbers for either value operand


def _tensors(a, b):
    """``a`` and ``b`` as tensors, a number filled to the other's shape."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a, b


def minimum(a, b):
    return torch.minimum(*_tensors(a, b))


def maximum(a, b):
    return torch.maximum(*_tensors(a, b))
