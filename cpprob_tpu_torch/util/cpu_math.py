"""A guard for PyTorch's CPU vector math on its first call in a process.

PyTorch's CPU build (2.13, with the bundled MKL) can return one intra-op
thread's chunk of the first multi-threaded ``torch.exp`` in a process
wrong, at ~1e-9 relative error in float64 and ~1e-4 in float32; every
later call is exact.  Over 100 fresh processes at 8 threads it hit 3
first float32 calls and 1 first float64 one (``util/first_exp.py``).
The plain versions of the port's kernels
take ``exp`` on CPU tensors, and the tests hold them bit for bit or at
float64 precision, so :func:`warm_vector_math` makes that first call
itself when the package is imported: one float32 and one float64 ``exp``
large enough that every intra-op thread takes a chunk.  With it no later
call was wrong in fresh processes (ROADMAP C4).  A thread count raised
after the import brings new threads that it has not warmed.
``util/first_exp.py`` counts such calls over fresh processes.
"""

from __future__ import annotations

import torch

__all__ = ["warm_vector_math"]

# elements a thread: two of ATen's 32,768-element grains, so every
# intra-op thread takes a chunk
_PER_THREAD = 1 << 16


def warm_vector_math() -> int:
    """One float32 and one float64 ``torch.exp`` over
    ``torch.get_num_threads() x 65,536`` zeros, results discarded.
    Returns the thread count it warmed."""
    threads = max(torch.get_num_threads(), 1)
    for dtype in (torch.float32, torch.float64):
        torch.exp(torch.zeros(threads * _PER_THREAD, dtype=dtype))
    return threads

