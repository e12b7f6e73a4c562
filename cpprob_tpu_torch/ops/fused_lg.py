"""Fused SMC kernel for the linear-Gaussian model — counterpart of the
linear-Gaussian part of ``cpprob_tpu/ops/pallas_hmm.py`` (``:669-942``).

One kernel, CUDA C++ in ``csrc/fused_lg.cu``, behind two wrappers:

- :func:`lg_chunk` (K7, <- ``pallas_lg_fused_chunk``): ``n_steps``
  random-walk moves x' = x + N(0, 1) and reweights log_w += N(y; x', 1),
  the particles held in registers, with ``n_valid`` masking, and one
  (max, sum e, sum e^2) record per CTA.
- :func:`lg_step` (K6, <- ``pallas_lg_fused_step``): the same kernel
  launched for one step.

Draws are Philox on counter (particle, t // 2, 0): the Box-Muller pair of
absolute step t feeds its cos half to the even step and its sin half to
the odd step, so a sweep's draws do not depend on its chunking.  Each
wrapper has a plain PyTorch version (``lg_chunk_plain``, ``lg_step_plain``)
on the same stream, or on pinned ε (``draws=``) for parity tests; the
wrappers take it for CPU tensors only and on CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .fused_hmm import _check, _raise_on, _stream, stats_from_partials
from .philox import philox4x32, split_seed, uniform_from_bits

__all__ = ["LAUNCHES", "LG_BLOCK", "lg_chunk", "lg_chunk_plain", "lg_step",
           "lg_step_plain", "make_fused_lg_ssm"]

LG_BLOCK = 4096          # 256 threads x 16 particles: one CTA, one record
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_TWO_PI = 2.0 * math.pi

# kernel launches by wrapper: "chunk" (K7) and "step" (K6, the one-step
# launch), counted where the kernel is launched
LAUNCHES = {"chunk": 0, "step": 0}


# --------------------------------------------------------------------------
# plain versions


def _normal_pair(seed: int, g: torch.Tensor, pair: int):
    """(r cos, r sin) of the Box-Muller pair at Philox counter (g, pair, 0)."""
    k0, k1 = split_seed(seed)
    b0, b1, _, _ = philox4x32(g, pair, 0, 0, k0, k1)
    u1 = torch.clamp(uniform_from_bits(b0), min=1e-12)
    ang = _TWO_PI * uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(ang), r * torch.sin(ang)


def _n_valid(n_valid, n_steps: int):
    """The valid-step count as a 0-d tensor (``None``: all steps)."""
    if n_valid is None:
        return torch.tensor(n_steps)
    return torch.as_tensor(n_valid).reshape(())


def lg_chunk_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                   ys: torch.Tensor, n_valid=None, *, t0: int = 1,
                   draws: torch.Tensor | None = None):
    """Plain version of the chunk kernel.  ``n_valid``: int32 device scalar
    (``None``: all ``ys`` valid); ``t0``: absolute time of the first step.
    ``draws``: ε (n_steps, n) or broadcastable, in place of Philox.  Returns
    (states, log_w, records (ceil(n / LG_BLOCK), 3))."""
    n, n_steps = states.shape[0], ys.shape[0]
    nv = _n_valid(n_valid, n_steps).to(states.device)
    g = torch.arange(n, device=states.device)
    x, w = states, log_w
    sin_half = None
    for t in range(n_steps):
        ta = t0 + t
        if draws is not None:
            eps = torch.broadcast_to(draws[t], (n,))
        elif ta % 2 == 0 or sin_half is None:
            cos_half, sin_half = _normal_pair(seed, g, ta // 2)
            eps = cos_half if ta % 2 == 0 else sin_half
        else:
            eps = sin_half
        nx = x + eps
        d = ys[t] - nx
        nw = w + (-0.5 * d * d - _HALF_LOG_2PI)
        valid = t < nv
        x = torch.where(valid, nx, x)
        w = torch.where(valid, nw, w)
    pad = -n % LG_BLOCK
    w2 = torch.nn.functional.pad(w, (0, pad), value=-math.inf).view(-1, LG_BLOCK)
    m = w2.amax(1)
    e = torch.exp(w2 - m[:, None])
    rec = torch.stack([m, e.sum(1), (e * e).sum(1)], 1)
    return x, w, rec


def lg_step_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                  y: torch.Tensor, t: int):
    """Plain version of the one-step launch at absolute time ``t``.
    Returns (states, log_w)."""
    x, w, _ = lg_chunk_plain(seed, states, log_w, y.reshape(1), t0=t)
    return x, w


# --------------------------------------------------------------------------
# kernel


def _lib():
    from ._build import load_library

    lib = load_library("fused_lg")
    if lib.lg_chunk_launch.argtypes is None:
        p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.lg_block.argtypes = []
        lib.lg_block.restype = i
        lib.lg_chunk_launch.argtypes = [
            p, i, p, u32, u32, u32, p, p, p, p, p, ctypes.c_longlong, p]
        lib.lg_chunk_launch.restype = i
        if lib.lg_block() != LG_BLOCK:
            raise RuntimeError(f"csrc/fused_lg.cu block differs from LG_BLOCK={LG_BLOCK}")
    return lib


def _launch(seed, states, log_w, ys, n_valid, t0, what):
    dev = states.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {dev}")
    _check(states, "states", torch.float32, dev)
    _check(log_w, "log_w", torch.float32, dev)
    _check(ys, "ys", torch.float32, dev)
    if n_valid is not None:
        _check(n_valid, "n_valid", torch.int32, dev)
        if n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
    n, n_steps = states.shape[0], ys.shape[0]
    if log_w.shape != states.shape or states.dim() != 1:
        raise ValueError("states and log_w must be (n,) alike")
    if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 32:
        raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^32")
    lib = _lib()
    x_out = torch.empty_like(states)
    w_out = torch.empty_like(log_w)
    rec = torch.empty((-(-n // LG_BLOCK), 3), dtype=torch.float32, device=dev)
    k0, k1 = split_seed(seed)
    err = lib.lg_chunk_launch(
        ys.data_ptr(), n_steps, None if n_valid is None else n_valid.data_ptr(),
        k0, k1, t0, states.data_ptr(), log_w.data_ptr(), x_out.data_ptr(),
        w_out.data_ptr(), rec.data_ptr(), n, _stream(dev))
    _raise_on(err, "lg_chunk_kernel")
    return x_out, w_out, rec


def lg_chunk(seed: int, states: torch.Tensor, log_w: torch.Tensor,
             ys: torch.Tensor, n_valid=None, *, t0: int = 1):
    """Fused chunk on the device of ``states``: the kernel on CUDA tensors,
    the plain version on CPU tensors (arguments as :func:`lg_chunk_plain`).
    Returns (states, log_w, records)."""
    if states.device.type == "cpu":
        return lg_chunk_plain(seed, states, log_w, ys, n_valid, t0=t0)
    out = _launch(seed, states, log_w, ys, n_valid, t0, "lg_chunk")
    LAUNCHES["chunk"] += 1
    return out


def lg_step(seed: int, states: torch.Tensor, log_w: torch.Tensor,
            y: torch.Tensor, t: int):
    """One fused step at absolute time ``t`` (``y`` a float32 scalar
    tensor): the kernel launched for one step on CUDA tensors, the plain
    version on CPU tensors.  Returns (states, log_w)."""
    if states.device.type == "cpu":
        return lg_step_plain(seed, states, log_w, y, t)
    x, w, _ = _launch(seed, states, log_w, y.reshape(1), None, t, "lg_step")
    LAUNCHES["step"] += 1
    return x, w


def make_fused_lg_ssm():
    """``linear_gaussian_ssm`` with the fused kernel installed as
    ``fused_step_batch`` (K6) and as the time-aware chunk hook
    ``fused_chunk_t_batch`` (K7: the Philox counters run on absolute time).
    ``key`` in both hooks is the sweep's integer seed."""
    from ..models.linear_gaussian import linear_gaussian_ssm

    def fused_step(key, states, log_w, y, t):
        return lg_step(key, states, log_w, y, t)

    def fused_chunk(key, states, log_w, ys, n_valid, t0):
        x, w, rec = lg_chunk(key, states, log_w, ys, n_valid.to(torch.int32),
                             t0=t0)
        ess, _, _ = stats_from_partials(rec, states.shape[0])
        return x, w, ess

    return dataclasses.replace(
        linear_gaussian_ssm,
        fused_step_batch=fused_step,
        fused_chunk_t_batch=fused_chunk,
    )
