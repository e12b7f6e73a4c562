"""Philox4x32-10 (Salmon et al., SC'11) in plain torch.

The CUDA kernels in ``csrc/`` carry the same generator (``philox.cuh``), so
a plain version and its kernel draw the same numbers from the same
(key, counter).  Values are uint32 held in int64 tensors; the 32x32->64
products are taken in 16-bit limbs so that no intermediate leaves the
signed 64-bit range.

Counters used by the chain kernels (``fused_hmm``), keyed on the sweep's
64-bit seed split into two 32-bit words: ``(particle >> 2, 0, 0, 0)`` the
initial states of four particles, word ``particle & 3`` for the particle;
``(island, absolute step t, 1, 0)`` an island's systematic
offset; ``(particle, t >> 2, 2, 0)`` the transition uniforms of four
absolute steps, word ``t & 3`` for step t (:func:`philox_uniforms4`).

A kernel reads its key from two int32 words on the card, which the
caller writes before the launch (:func:`launch_key`), so that a captured
CUDA graph of the launch draws from whatever key was written before each
replay.  Every wrapper, and every plain version, takes the seed as an
integer or as a device key (:func:`device_key`, :func:`write_key`).
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "philox_uniform", "philox_uniforms4", "uniform_from_bits",
           "split_seed", "device_key", "write_key", "launch_key"]

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


def split_seed(seed):
    """64-bit seed -> the two 32-bit key words; a device key
    (:func:`device_key`) -> its words, read on the host."""
    if isinstance(seed, torch.Tensor):
        k0, k1 = (int(k) & _MASK32 for k in _check_key(seed).tolist())
        return k0, k1
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def _check_key(key: torch.Tensor) -> torch.Tensor:
    if key.dtype != torch.int32 or key.shape != (2,) or not key.is_contiguous():
        raise ValueError("a device key is a contiguous (2,) int32 tensor")
    return key


def _signed(words):
    """uint32 words as the int32 values that hold their bits."""
    return [w - (1 << 32) if w >= 1 << 31 else w for w in words]


def device_key(seed: int, device) -> torch.Tensor:
    """The key words of ``seed`` as a (2,) int32 tensor on ``device``."""
    return torch.tensor(_signed(split_seed(seed)), dtype=torch.int32, device=device)


def write_key(key: torch.Tensor, seed: int) -> None:
    """Write the key words of ``seed`` into the device key ``key``, queued
    on the current stream from pinned host memory: no kernel, no wait."""
    host = torch.tensor(_signed(split_seed(seed)), dtype=torch.int32, pin_memory=True)
    _check_key(key).copy_(host, non_blocking=True)


# the key of a launch given an integer seed, by (device, stream): two int32
# words that :func:`launch_key` writes before each such launch
_KEYS: dict = {}


def launch_key(seed, device) -> int:
    """A wrapper's ``seed`` as its kernel's launch on ``device`` takes it:
    the address of the key's two words on the card.  A device key on
    ``device`` goes as it is; an integer is written (:func:`write_key`)
    into the current stream's own key, which the launch that follows on the
    stream reads.  An integer while the stream is captured into a CUDA
    graph raises ``RuntimeError``: the graph would replay the key of its
    capture."""
    if isinstance(seed, torch.Tensor):
        if seed.device != torch.device(device):
            raise ValueError(f"the device key is on {seed.device}, expected {device}")
        return _check_key(seed).data_ptr()
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an integer seed under CUDA graph capture: pass a "
                           "device key (device_key), which each replay rewrites")
    slot = (torch.device(device), torch.cuda.current_stream(device).cuda_stream)
    key = _KEYS.get(slot)
    if key is None:
        key = _KEYS[slot] = torch.zeros(2, dtype=torch.int32, device=device)
    write_key(key, seed)
    return key.data_ptr()


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


def philox_uniforms4(seed: int, c0, c1, c2=0) -> torch.Tensor:
    """float32 uniforms from the four words of Philox at counter ``(c0, c1,
    c2, 0)`` under ``seed``, stacked on a new first axis of length 4: the
    uniforms a kernel draws from one call, word j at ``[j]``."""
    k0, k1 = split_seed(seed)
    return torch.stack([uniform_from_bits(x) for x in philox4x32(c0, c1, c2, 0, k0, k1)])
