"""The population launcher — counterpart of ``_pallas_population_call``
(``cpprob_tpu/ops/pallas_ssm.py:366-394``).

Every population kernel of the port (the HMM init and chunk kernels, the
linear-Gaussian chunk kernel, the user-physics and guided scalar kernels) takes
(seed, observations, control, states, log_w) and writes (states', log_w',
one statistics record per CTA).  :func:`launch_population` is the one
place that checks the inputs, allocates the outputs and the records,
launches, raises on a refused launch and counts it, inside the span
``launch.<kernel>`` of a recording profiler; the kernels' outputs do not
depend on it; :func:`stats_from_partials` combines the records.

The helpers below it (:func:`check_tensor`, :func:`raise_on`,
:func:`current_stream`, :func:`mlp_layers`, :func:`stream_scratch`,
:func:`takes_device_key`) serve the other kernel wrappers too.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..util.profiling import span

__all__ = ["launch_population", "stats_from_partials", "check_tensor",
           "raise_on", "current_stream", "mlp_layers", "stream_scratch",
           "owned_scratch", "takes_device_key"]


def check_tensor(t: torch.Tensor, name: str, dtype, device):
    """Raise unless ``t`` lies on ``device``, has ``dtype`` and is
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err, what: str):
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a ``ctypes`` launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# the scratch tables of the CUDA graphs being captured, innermost last
_OWNERS: list = []


def stream_scratch(table: dict) -> dict:
    """The dict that holds a kernel's per-(device, stream) scratch:
    ``table``, the module's own, or while a sweep's graph is captured
    (:func:`owned_scratch`) that graph's copy of it, so that the scratch a
    graph captured is its own, shared with no eager launch and no other
    graph."""
    if not _OWNERS:
        return table
    return _OWNERS[-1].setdefault(id(table), {})


@contextlib.contextmanager
def owned_scratch():
    """While the block runs, :func:`stream_scratch` gives the tables of a
    new owner; yields the owner (a dict of those tables), which keeps the
    scratch alive as long as it is held."""
    owner: dict = {}
    _OWNERS.append(owner)
    try:
        yield owner
    finally:
        _OWNERS.pop()


def takes_device_key(hook: Callable) -> Callable:
    """Mark a model's hook as one whose draws come only from the sweep's
    seed, which it takes as a device key (``ops.philox.device_key``) as
    well as an integer, or from the sweep's generator (which a captured
    graph registers), and that does nothing on the host that a replay of
    its work would have to repeat;
    :func:`~cpprob_tpu_torch.inference.smc.build_smc_run` captures a query
    whose hooks are all so marked.  Returns ``hook``."""
    hook.device_key = True
    return hook


def _host_f32(a) -> np.ndarray:
    """A kernel's table (a tensor on any device, or anything ``np.asarray``
    takes) as a contiguous float32 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.ascontiguousarray(a, np.float32)


def mlp_layers(params):
    """An MLP's layers ``[{"w": (in, out), "b": (out,)}, ...]`` as float32
    numpy ``(Ws, bs)`` for a kernel's tables.  Raises ``ValueError`` unless
    there is a layer and each chains to the next."""
    Ws = [_host_f32(layer["w"]) for layer in params]
    bs = [_host_f32(layer["b"]) for layer in params]
    if not Ws:
        raise ValueError("the proposal net has no layers")
    for i, (W, b) in enumerate(zip(Ws, bs)):
        if W.ndim != 2 or b.shape != (W.shape[1],) or (
                i and W.shape[0] != Ws[i - 1].shape[1]):
            raise ValueError(f"layer {i} of the proposal net does not chain: "
                             f"w {W.shape}, b {b.shape}")
    return Ws, bs


def launch_population(what: str, launch: Callable, *, span_name: str, device,
                      inputs: Sequence = (), outputs: Sequence = (),
                      records: tuple, counts: dict, count_key: str):
    """Launch one population kernel on ``device`` (a CUDA device).

    ``inputs``: (tensor, name, dtype) triples to check.  ``outputs``:
    (shape, dtype) of each output, allocated with ``torch.empty``.
    ``records``: the (rows, columns) of the float32 per-CTA records.
    ``launch(*outputs, records)`` launches the kernel on the current stream
    and returns its CUDA error (0 when launched).  On success
    ``counts[count_key]`` goes up by one.  Returns ``(*outputs, records)``.
    The checks, the allocations and the launch lie in the span
    ``span_name``, a fixed ``"launch.<kernel>"`` (``util.profiling.span``);
    ``what`` names the kernel in errors.
    """
    with span(span_name):
        if device.type != "cuda":
            raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")
        for t, name, dtype in inputs:
            check_tensor(t, name, dtype, device)
        outs = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype in outputs]
        rec = torch.empty(records, dtype=torch.float32, device=device)
        raise_on(launch(*outs, rec), what)
    counts[count_key] += 1
    return (*outs, rec)


def stats_from_partials(records: torch.Tensor, n: int):
    """Combine records into (ess, normalized category weights (K,),
    log-mean-exp of the weights), in float64.  Records of width 3 (max,
    sum e, sum e^2), as the linear-Gaussian kernel writes, carry no
    category columns and give an empty ``cat_w``."""
    r = records.double()
    n_cat = max(r.shape[1] - 4, 0)
    m_b, s1_b, s2_b, c_bk = r[:, 0], r[:, 1], r[:, 2], r[:, 3:3 + n_cat]
    m = m_b.max()
    scale = torch.exp(m_b - m)
    s1 = torch.sum(s1_b * scale)
    s2 = torch.sum(s2_b * scale * scale)
    ess = s1 * s1 / torch.clamp(s2, min=1e-300)
    cat_w = torch.sum(c_bk * scale[:, None], 0) / torch.clamp(s1, min=1e-300)
    lme = m + torch.log(torch.clamp(s1, min=1e-300)) - math.log(n)
    return ess, cat_w, lme


def _ess_chunk_hook(chunk: Callable, device_key: bool = False) -> Callable:
    """``chunk(seed, states, log_w, ys, n_valid, t0=)``, a chunk launch that
    returns (states', log_w', records), as a model's time-aware chunk hook
    ``(seed, states, log_w, ys, n_valid, t0) -> (states', log_w', ess')``,
    marked :func:`takes_device_key` where ``chunk`` takes one."""
    def hook(key, states, log_w, ys, n_valid, t0):
        x, w, rec = chunk(key, states, log_w, ys, n_valid.to(torch.int32), t0=t0)
        return x, w, stats_from_partials(rec, states.shape[0])[0]

    return takes_device_key(hook) if device_key else hook
