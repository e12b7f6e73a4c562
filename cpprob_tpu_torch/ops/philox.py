"""Philox4x32-10 (Salmon et al., SC'11) in plain torch.

The CUDA kernels in ``csrc/`` carry the same generator (``philox.cuh``), so
a plain version and its kernel draw the same numbers from the same
(key, counter).  Values are uint32 held in int64 tensors; the 32x32->64
products are taken in 16-bit limbs so that no intermediate leaves the
signed 64-bit range.

Counters used by the port: ``(particle index, absolute time step, stream,
0)``, keyed on the sweep's 64-bit seed split into two 32-bit words.
Stream 0 draws the per-particle transition uniforms, stream 1 the
per-island systematic offset.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "philox_uniform", "uniform_from_bits", "split_seed"]

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of constant ``m`` and
    uint32 values ``x`` (int64 tensor)."""
    mh, ml = m >> 16, m & _MASK16
    xh, xl = x >> 16, x & _MASK16
    ll = ml * xl
    mid = (ll >> 16) + mh * xl + ml * xh          # < 2^34
    hi = mh * xh + (mid >> 16)
    lo = ((mid & _MASK16) << 16) | (ll & _MASK16)
    return hi, lo


def split_seed(seed: int):
    """64-bit seed -> the two 32-bit key words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds of Philox4x32 on counter words ``c0..c3`` (int64 tensors
    or ints broadcastable to a common shape, values in [0, 2^32)) under key
    ``(k0, k1)``.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3))
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform_from_bits(x: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a uint32 word -> float32 in [0, 1), exactly."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniform(seed: int, c0, c1, c2=0) -> torch.Tensor:
    """float32 uniforms from word 0 of Philox at counter ``(c0, c1, c2, 0)``
    under ``seed`` — the draw the kernels make for the same counter."""
    k0, k1 = split_seed(seed)
    x, _, _, _ = philox4x32(c0, c1, c2, 0, k0, k1)
    return uniform_from_bits(x)
