"""Fused SMC kernel for the linear-Gaussian model — counterpart of the
linear-Gaussian part of ``cpprob_tpu/ops/pallas_hmm.py`` (``:669-942``).

Two kernels, CUDA C++ in ``csrc/fused_lg.cu``, behind four wrappers:

- :func:`lg_chunk` (K7, <- ``pallas_lg_fused_chunk``): ``n_steps``
  random-walk moves x' = x + N(0, 1) and reweights log_w += N(y; x', 1),
  the particles held in registers, with ``n_valid`` masking, and one
  (max, sum e, sum e^2) record per CTA.
- :func:`lg_step` (K6, <- ``pallas_lg_fused_step``): the same kernel
  launched for one step.
- :func:`lg_step_ctrl` (K6 with the step's resample control): the one-step
  launch that takes the step's resample flag (set: every particle starts
  from weight 0) and leaves the ESS and the next step's flag, combined
  from the records by the launch's last CTA, on the device.
- :func:`lg_init` (``lg_init_kernel``, the sweep's start; the JAX package
  starts with plain XLA operations): x_0 ~ N(0, 1) from the draw of
  absolute step 0, weighted by N(y_0; x_0, 1), with the population's ESS
  and the first step's resample flag combined as ``lg_step_ctrl``'s.

Draws are Philox on counter (particle, t // 2, 0): the Box-Muller pair of
absolute step t feeds its cos half to the even step and its sin half to
the odd step, so a sweep's draws do not depend on its chunking.  Each
wrapper has a plain PyTorch version (``lg_chunk_plain``, ``lg_step_plain``,
``lg_step_ctrl_plain``, ``lg_init_plain``) on the same stream, or on pinned
ε (``draws=``) for parity tests; the wrappers take it for CPU tensors only
and on CUDA tensors launch the kernel or raise.

``seed``, in every wrapper and plain version, is an integer or a device key
(:func:`.philox.device_key`, two int32 words on the population's device).
The kernels read the key's words on the card (``csrc/philox.cuh``
``LaunchKey``; an integer is written there first, :func:`.philox.launch_key`),
so that a captured CUDA graph of a launch given a device key draws from the
key written before each replay; a plain version reads them on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..util.profiling import counter_group
from .philox import launch_key, philox4x32, split_seed, uniform_from_bits
from .population import (_ess_chunk_hook, check_tensor, current_stream,
                         launch_population, stats_from_partials, stream_scratch,
                         takes_device_key)

__all__ = ["LAUNCHES", "LG_BLOCK", "lg_chunk", "lg_chunk_plain", "lg_init",
           "lg_init_plain", "lg_step", "lg_step_ctrl", "lg_step_ctrl_plain",
           "lg_step_plain", "make_fused_lg_ssm", "normal_steps"]

LG_BLOCK = 4096          # 256 threads x 16 particles: one CTA, one record
# the part of a mangled name that picks K7's instance of the kernel (no step
# control), for the SASS reports of util/sass.py
K7_SYMBOL = "lg_chunk_kernelILb0E"
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_TWO_PI = 2.0 * math.pi

# kernel launches by wrapper: "chunk" (K7), "step" (K6, the one-step
# launch), "step_ctrl" (K6 with the step's resample control) and "init"
# (lg_init_kernel), counted where the kernel is launched
LAUNCHES = counter_group("fused_lg", ("chunk", "step", "step_ctrl", "init"))


# --------------------------------------------------------------------------
# plain versions


def box_muller(b0: torch.Tensor, b1: torch.Tensor):
    """(r cos, r sin) of the Box-Muller pair of two Philox words
    (``csrc/philox.cuh`` ``box_muller``)."""
    u1 = torch.clamp(uniform_from_bits(b0), min=1e-12)
    ang = _TWO_PI * uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(ang), r * torch.sin(ang)


def _normal_pair(seed: int, g: torch.Tensor, pair: int, plane: int = 0):
    """(r cos, r sin) of the Box-Muller pair at Philox counter (g, pair,
    plane)."""
    k0, k1 = split_seed(seed)
    b0, b1, _, _ = philox4x32(g, pair, plane, 0, k0, k1)
    return box_muller(b0, b1)


def normal_steps(seed: int, g: torch.Tensor, t0: int, n_steps: int):
    """The eps of each step of a launch whose first step is absolute step
    ``t0``, as the scalar kernels draw them: the pair of step t on counter
    (g, t // 2, 0), its cos half at even t, its sin half at odd t (a launch
    starting at odd t computes the pair).  Yields a one-tensor list per
    step."""
    sin_half = None
    for ta in range(t0, t0 + n_steps):
        if ta % 2 == 0 or sin_half is None:
            cos_half, sin_half = _normal_pair(seed, g, ta // 2)
            yield [cos_half if ta % 2 == 0 else sin_half]
        else:
            yield [sin_half]


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
    x, w = states, log_w
    philox = normal_steps(seed, torch.arange(n, device=states.device), t0,
                          n_steps) if draws is None else None
    for t in range(n_steps):
        eps = (next(philox)[0] if draws is None
               else torch.broadcast_to(draws[t], (n,)))
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


def lg_step_ctrl_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                       y: torch.Tensor, t: int, flag: torch.Tensor,
                       threshold: float):
    """Plain version of the one-step launch with the step's resample
    control: where ``flag`` (int32 scalar) is set the weights start from
    0; the ESS from ``stats_from_partials`` on the records.  Returns
    (states, log_w, ess (float64), next flag (int32): ess < threshold)."""
    w = torch.where(flag.reshape(()) != 0, torch.zeros_like(log_w), log_w)
    x, w, rec = lg_chunk_plain(seed, states, w, y.reshape(1), t0=t)
    ess = stats_from_partials(rec, states.shape[0])[0]
    return x, w, ess, (ess < threshold).to(torch.int32)


def lg_init_plain(seed: int, n: int, y0: torch.Tensor, threshold: float):
    """Plain version of the sweep's start on ``y0``'s device: the one-step
    chunk at absolute time 0 on zero states and weights, the ESS from
    ``stats_from_partials`` on its records.  Returns (states, log_w, ess
    (float64), first flag (int32): ess < threshold)."""
    zeros = torch.zeros(n, device=y0.device)
    x, w, rec = lg_chunk_plain(seed, zeros, zeros, y0.reshape(1), t0=0)
    ess = stats_from_partials(rec, n)[0]
    return x, w, ess, (ess < threshold).to(torch.int32)


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("fused_lg")
    if lib.lg_chunk_launch.argtypes is None:
        p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.lg_block.argtypes = []
        lib.lg_block.restype = i
        lib.lg_chunk_launch.argtypes = [
            p, i, p, p, u32, p, p, p, p, p, ctypes.c_longlong, p,
            p, p, p, p, ctypes.c_double]
        lib.lg_chunk_launch.restype = i
        lib.lg_init_launch.argtypes = [
            p, p, p, p, p, ctypes.c_longlong, p, p, p, p, ctypes.c_double]
        lib.lg_init_launch.restype = i
        if lib.lg_block() != LG_BLOCK:
            raise RuntimeError(f"csrc/fused_lg.cu block differs from LG_BLOCK={LG_BLOCK}")
    return lib


def _launch(seed, states, log_w, ys, n_valid, t0, what, count_key,
            flag=None, threshold=0.0):
    """The kernel; with ``flag`` (int32 device scalar) the step's resample
    control, whose ESS (float64) and next flag (int32) follow the
    records among the outputs."""
    dev = states.device
    if n_valid is not None:
        if dev.type == "cuda":
            check_tensor(n_valid, "n_valid", torch.int32, dev)
        if n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
    n, n_steps = states.shape[0], ys.shape[0]
    if log_w.shape != states.shape or states.dim() != 1:
        raise ValueError("states and log_w must be (n,) alike")
    if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 32:
        raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^32")
    inputs = [(states, "states", torch.float32), (log_w, "log_w", torch.float32),
              (ys, "ys", torch.float32)]
    outputs = [(n, torch.float32), (n, torch.float32)]
    if flag is not None:
        if flag.numel() != 1:
            raise ValueError("flag must be one int32 element")
        inputs.append((flag, "flag", torch.int32))
        outputs += [((), torch.float64), ((), torch.int32)]

    def launch(x_out, w_out, *rest):
        *ctrl_out, rec = rest
        stream = current_stream(dev)
        if flag is None:
            ctrl = (None, None, None, None, 0.0)
        else:
            ess, nxt = ctrl_out
            ctrl = (flag.data_ptr(), _ticket(dev, stream.value).data_ptr(),
                    ess.data_ptr(), nxt.data_ptr(), threshold)
        return _lib().lg_chunk_launch(
            ys.data_ptr(), n_steps,
            None if n_valid is None else n_valid.data_ptr(),
            launch_key(seed, dev), t0, states.data_ptr(), log_w.data_ptr(),
            x_out.data_ptr(), w_out.data_ptr(), rec.data_ptr(), n, stream, *ctrl)

    return launch_population(
        what, launch, span_name="launch.lg_chunk_kernel", device=dev,
        inputs=inputs, outputs=outputs, records=(-(-n // LG_BLOCK), 3),
        counts=LAUNCHES, count_key=count_key)


# the step control's ticket by (device, stream): one int, zeroed once here
# and zero again after every launch (the kernel's last CTA clears it); a
# captured graph keeps its own (population.stream_scratch)
_TICKETS: dict = {}


def _ticket(dev, stream: int) -> torch.Tensor:
    key, tickets = (dev, stream), stream_scratch(_TICKETS)
    if key not in tickets:
        tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return tickets[key]


def lg_chunk(seed: int, states: torch.Tensor, log_w: torch.Tensor,
             ys: torch.Tensor, n_valid=None, *, t0: int = 1):
    """Fused chunk on the device of ``states``: the kernel on CUDA tensors,
    the plain version on CPU tensors (arguments as :func:`lg_chunk_plain`).
    Returns (states, log_w, records)."""
    if states.device.type == "cpu":
        return lg_chunk_plain(seed, states, log_w, ys, n_valid, t0=t0)
    return _launch(seed, states, log_w, ys, n_valid, t0, "lg_chunk_kernel",
                   "chunk")


def lg_step(seed: int, states: torch.Tensor, log_w: torch.Tensor,
            y: torch.Tensor, t: int):
    """One fused step at absolute time ``t`` (``y`` a float32 scalar
    tensor): the kernel launched for one step on CUDA tensors, the plain
    version on CPU tensors.  Returns (states, log_w)."""
    if states.device.type == "cpu":
        return lg_step_plain(seed, states, log_w, y, t)
    x, w, _ = _launch(seed, states, log_w, y.reshape(1), None, t,
                      "lg_chunk_kernel (one step)", "step")
    return x, w


def lg_step_ctrl(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                 y: torch.Tensor, t: int, flag: torch.Tensor,
                 threshold: float):
    """One fused step at absolute time ``t`` with the step's resample
    control: where ``flag`` (int32 scalar on the population's device) is
    set, every particle starts from weight 0; ``threshold`` is the ESS
    below which the next step resamples (float64, ``ess_threshold * n``).
    The kernel on CUDA tensors (its last CTA combines the records in
    float64), the plain version on CPU tensors.  Returns (states, log_w,
    ess (float64 scalar), next flag (int32 scalar))."""
    if states.device.type == "cpu":
        return lg_step_ctrl_plain(seed, states, log_w, y, t, flag, threshold)
    x, w, ess, nxt, _ = _launch(
        seed, states, log_w, y.reshape(1), None, t,
        "lg_chunk_kernel (one step, step control)", "step_ctrl",
        flag=flag, threshold=float(threshold))
    return x, w, ess, nxt


def _init_launch(seed: int, n: int, y0: torch.Tensor, threshold: float):
    """``lg_init_kernel``: (states, log_w, ess, first flag, records)."""
    dev = y0.device
    if y0.numel() != 1:
        raise ValueError("y0 must be one float32 element")
    if not 0 < n < 2 ** 31:
        raise ValueError("need 0 < n < 2^31")
    def launch(x_out, w_out, ess, nxt, rec):
        stream = current_stream(dev)
        return _lib().lg_init_launch(
            y0.data_ptr(), launch_key(seed, dev), x_out.data_ptr(),
            w_out.data_ptr(), rec.data_ptr(), n, stream, _ticket(dev, stream.value).data_ptr(),
            ess.data_ptr(), nxt.data_ptr(), float(threshold))

    return launch_population(
        "lg_init_kernel", launch, span_name="launch.lg_init_kernel", device=dev,
        inputs=[(y0, "y0", torch.float32)],
        outputs=[(n, torch.float32), (n, torch.float32), ((), torch.float64),
                 ((), torch.int32)],
        records=(-(-n // LG_BLOCK), 3), counts=LAUNCHES, count_key="init")


def lg_init(seed: int, n: int, y0: torch.Tensor, threshold: float):
    """The sweep's start on ``y0``'s device (``y0`` a float32 scalar
    tensor): ``n`` particles x_0 ~ N(0, 1) from the draw of absolute step
    0, weighted by N(y_0; x_0, 1); ``threshold`` is the ESS below which the
    first step resamples (float64, ``ess_threshold * n``).  The kernel on a
    CUDA tensor (its last CTA combines the records in float64), the plain
    version on a CPU tensor.  Returns (states, log_w, ess (float64 scalar),
    first flag (int32 scalar))."""
    if y0.device.type == "cpu":
        return lg_init_plain(seed, n, y0, threshold)
    return _init_launch(seed, n, y0, threshold)[:4]


def make_fused_lg_ssm():
    """``linear_gaussian_ssm`` with the fused kernel installed as
    ``fused_step_batch`` (K6), as ``fused_step_ctrl_batch`` (K6 with the
    step's resample control, the per-step path of ``build_smc_run``) and
    as the time-aware chunk hook ``fused_chunk_t_batch`` (K7: the Philox
    counters run on absolute time), and ``lg_init_kernel`` as
    ``fused_init_ctrl_batch`` (the sweep's start, with its ESS and first
    flag).  ``key`` in the hooks is the sweep's integer seed or its device
    key: the four hooks are marked ``takes_device_key``."""
    from ..models.linear_gaussian import linear_gaussian_ssm

    def fused_step_ctrl(key, states, log_w, y, t, flag, threshold):
        x, w, _, nxt = lg_step_ctrl(key, states, log_w, y, t, flag, threshold)
        return x, w, nxt

    return dataclasses.replace(
        linear_gaussian_ssm,
        fused_step_batch=lg_step,
        fused_step_ctrl_batch=takes_device_key(fused_step_ctrl),
        fused_chunk_t_batch=_ess_chunk_hook(lg_chunk, device_key=True),
        fused_init_ctrl_batch=takes_device_key(lg_init),
    )
