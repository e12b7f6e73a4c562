"""The streaming systematic resample epoch for scalar float32 populations —
counterpart of ``cpprob_tpu/ops/pallas_resample.py``.

CUDA C++ in ``csrc/stream_resample.cu``; each wrapper has a plain PyTorch
twin, which it runs on CPU tensors only (on CUDA tensors it launches the
kernel or raises):

- :func:`logsumexp_stats` (K14, <- ``logsumexp_stats``): ``stats = (m,
  wtot)``, ``m = max(log_w)``, ``wtot = sum(exp(log_w - m))``, a float64
  (2,) tensor on the population's device: one launch of
  ``lse_stats_kernel``, whose last CTA combines the CTAs' records.  Its
  records and ticket are scratch kept per stream, zeroed once; two calls
  on the same weights give bit-equal stats.
- :func:`resample_pass1` (K15, <- ``_pass1``): the start slots
  ``st_j = ceil(n * cdf_{j-1} - u0)`` clipped to [0, n], int32, from the
  exclusive prefix of the normalised weights: one single-pass scan
  (``pass1_scan_kernel``, a decoupled look-back over tiles of
  ``512 * PASS1_PER_THREAD`` particles) that reads each weight once and
  writes each slot once.  Its scratch (a ticket, a tile count and a status
  word per tile) is kept per stream, zeroed once, and left clean by each
  launch; two streams never share one.
- :func:`resample_pass2` (K16, <- ``_streaming_resample(impl=...)``):
  slot ``i`` takes the value of the last particle ``j`` with ``st_j <= i``;
  the exact expansion of the start slots, by one kernel
  (``pass2_tile_kernel``).  ``impl`` names the reference's variant and
  sets only the layout: ``"scatter"`` (the default) and ``"fast"`` put slot
  ``i`` at position ``i``; ``"merge"`` puts slot ``og * 128 + s`` of tile
  ``t`` (16,384 slots) at ``t * 16384 + s * 128 + og`` and takes whole
  tiles only.

Exp, the prefix and the slot arithmetic are float64 (the reference's
float32 prefix is exact only to about 2^24 particles).  Inputs keep their
order: this is plain systematic resampling, not the sorted-fill variant.
``flag`` (an int32 device scalar) lets a chunk boundary that does not
resample skip the epoch without a host sync: the kernels do no work and
pass 2 copies the values.
"""

from __future__ import annotations

import ctypes

import torch

from ..util.profiling import counter_group, span
from .population import check_tensor as _check
from .population import current_stream as _stream
from .population import raise_on as _raise_on
from .population import stream_scratch as _stream_scratch

__all__ = [
    "IMPLS", "LAUNCHES", "LSE_PER_BATCH", "OUT_TILE", "PASS1_PER_THREAD", "logsumexp_stats", "logsumexp_stats_plain", "resample_pass1",
    "resample_pass1_plain", "resample_pass2", "resample_pass2_plain",
    "streaming_available", "streaming_systematic_resample_values",
]

_THREADS = 256          # threads per CTA of the stats kernel (csrc kThreads)
LSE_PER_BATCH = 16      # weights a thread of the stats kernel loads per batch (4 kLseVec)
_P1_THREADS = 256       # threads per CTA of pass 1 (csrc kP1Threads)
PASS1_PER_THREAD = 16   # particles per thread of pass 1 (csrc kPer)
OUT_TILE = 128 * 128    # slots per pass-2 tile
IMPLS = ("scatter", "fast", "merge")

# kernel launches by wrapper, counted where each wrapper launches its
# kernels; pass 2 by variant
LAUNCHES = counter_group("stream_resample", (
    "lse_stats", "pass1", "pass2", "pass2_fast", "pass2_merge"))


# --------------------------------------------------------------------------
# plain versions


def logsumexp_stats_plain(log_w: torch.Tensor) -> torch.Tensor:
    """(m, wtot) as a float64 (2,) tensor."""
    m = log_w.max().double()
    return torch.stack([m, torch.exp(log_w.double() - m).sum()])


def resample_pass1_plain(u0, log_w: torch.Tensor,
                         stats: torch.Tensor) -> torch.Tensor:
    """Start slots (n,) int32 for the comb offset ``u0`` in [0, 1)."""
    n = log_w.shape[0]
    e = torch.exp(log_w.double() - stats[0])
    excl = torch.cat([e.new_zeros(1), torch.cumsum(e, 0)[:-1]])
    x = n * (excl / stats[1]) - u0
    return torch.clamp(torch.ceil(x), 0, n).to(torch.int32)


def _check_impl(impl: str, n: int):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "merge" and n % OUT_TILE:
        raise ValueError(f"impl='merge' takes n a multiple of {OUT_TILE}, got {n}")


def resample_pass2_plain(st: torch.Tensor, states: torch.Tensor,
                         flag=None, impl: str = "scatter") -> torch.Tensor:
    """The values of the expansion of the start slots ``st``, in the layout
    of ``impl``; ``states`` themselves where ``flag`` is 0."""
    n = states.shape[0]
    _check_impl(impl, n)
    slots = torch.arange(n, dtype=st.dtype, device=st.device)
    owner = torch.searchsorted(st, slots, right=True) - 1
    out = states[torch.clamp(owner, min=0)]
    if impl == "merge":
        out = out.view(-1, 128, 128).transpose(1, 2).reshape(n)
    return out if flag is None else torch.where(flag.reshape(()) != 0, out, states)


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("stream_resample")
    if lib.pass1_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("lse_threads", "lse_per_batch", "pass1_threads",
                     "pass1_per_thread"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.lse_stats_launch.argtypes = [p, ll, p, p, p, p, i, p, p]
        lib.lse_stats_launch.restype = i
        lib.pass1_launch.argtypes = [p, ll, p, p, p, p, p, p, p, p]
        lib.pass1_launch.restype = i
        lib.pass2_tile_launch.argtypes = [p, p, ll, p, i, p, p]
        lib.pass2_tile_launch.restype = i
        lib.pass2_out_tile.argtypes = []
        lib.pass2_out_tile.restype = i
        if (lib.lse_threads(), lib.lse_per_batch(), lib.pass1_threads(),
                lib.pass1_per_thread(), lib.pass2_out_tile()) != (
                _THREADS, LSE_PER_BATCH, _P1_THREADS, PASS1_PER_THREAD, OUT_TILE):
            raise RuntimeError("csrc/stream_resample.cu tiles differ from "
                               f"{_THREADS} x {LSE_PER_BATCH}, {_P1_THREADS} x "
                               f"{PASS1_PER_THREAD}, OUT_TILE={OUT_TILE}")
    return lib


def _cuda_inputs(what: str, *named):
    """Checks (tensor, name, dtype) triples for a kernel launch; returns the
    device.  Raises on a device that is neither cpu nor cuda."""
    dev = named[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {dev}")
    for t, name, dtype in named:
        _check(t, name, dtype, dev)
    return dev


def _flag_ptr(flag, dev):
    if flag is None:
        return None
    if flag.dtype != torch.int32 or flag.numel() != 1 or flag.device != dev:
        raise ValueError("flag must be one int32 element on the population's device")
    return flag.data_ptr()


def _check_n(n: int):
    if not streaming_available(n):
        raise ValueError(f"the streaming epoch takes 0 < n < 2^31, got {n}")


def logsumexp_stats(log_w: torch.Tensor, flag=None) -> torch.Tensor:
    """(m, wtot) of ``log_w`` (n,) float32 as a float64 (2,) tensor: the
    kernel on a CUDA tensor (undefined where ``flag`` is 0), the plain
    version on a CPU tensor."""
    if log_w.device.type == "cpu":
        return logsumexp_stats_plain(log_w)
    with span("launch.lse_stats_kernel"):
        dev = _cuda_inputs("logsumexp_stats", (log_w, "log_w", torch.float32))
        n = log_w.shape[0]
        _check_n(n)
        lib = _lib()
        stream = _stream(dev)
        rec_m, rec_s, ticket = _lse_scratch(dev, stream.value)
        stats = torch.empty(2, dtype=torch.float64, device=dev)
        err = lib.lse_stats_launch(log_w.data_ptr(), n, _flag_ptr(flag, dev),
                                   rec_m.data_ptr(), rec_s.data_ptr(),
                                   ticket.data_ptr(), rec_m.shape[0],
                                   stats.data_ptr(), stream)
        _raise_on(err, "lse_stats_kernel")
    LAUNCHES["lse_stats"] += 1
    return stats


# the stats kernel's scratch by (device, stream): (rec_m (cap,), rec_s
# (cap,), ticket (1,)), cap the most CTAs of 256 threads the card holds at
# once (2,048 threads an SM); all zeroed once here, and the ticket zero
# again after every flagged launch (the kernel's last CTA clears it); a
# captured graph keeps its own (population.stream_scratch)
_LSE_SCRATCH: dict = {}


def _lse_scratch(dev, stream: int):
    key, table = (dev, stream), _stream_scratch(_LSE_SCRATCH)
    sc = table.get(key)
    if sc is None:
        cap = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
        sc = (torch.zeros(cap, dtype=torch.float32, device=dev),
              torch.zeros(cap, dtype=torch.float64, device=dev),
              torch.zeros(1, dtype=torch.int32, device=dev))
        table[key] = sc
    return sc


# pass 1's scratch by (device, stream): (ctr (2,), status (cap,), vals
# (2 cap,)); ctr and status zeroed once here, and zero again after every
# launch (the kernel's last CTA clears them); a captured graph keeps its own
_PASS1_SCRATCH: dict = {}


def _pass1_scratch(dev, stream: int, n_tiles: int):
    key, table = (dev, stream), _stream_scratch(_PASS1_SCRATCH)
    sc = table.get(key)
    if sc is None or sc[1].shape[0] < n_tiles:
        cap = max(n_tiles, 1024)
        sc = (torch.zeros(2, dtype=torch.int32, device=dev),
              torch.zeros(cap, dtype=torch.int32, device=dev),
              torch.empty(2 * cap, dtype=torch.float64, device=dev))
        table[key] = sc
    ctr, status, vals = sc
    # the kernel reads the inclusive prefixes at vals[n_tiles:]
    return ctr, status, vals[:2 * n_tiles]


def resample_pass1(u0, log_w: torch.Tensor, stats: torch.Tensor,
                   flag=None) -> torch.Tensor:
    """Start slots (n,) int32 for the comb offset ``u0`` (float64 scalar
    tensor on the population's device) and ``stats`` from
    :func:`logsumexp_stats`: the kernel on CUDA tensors (undefined where
    ``flag`` is 0), the plain version on CPU tensors."""
    dev = log_w.device
    u0 = torch.as_tensor(u0, dtype=torch.float64, device=dev)
    if dev.type == "cpu":
        return resample_pass1_plain(u0, log_w, stats)
    with span("launch.pass1_scan_kernel"):
        _cuda_inputs("resample_pass1", (log_w, "log_w", torch.float32),
                     (stats, "stats", torch.float64), (u0, "u0", torch.float64))
        n = log_w.shape[0]
        _check_n(n)
        if stats.shape != (2,) or u0.numel() != 1:
            raise ValueError("stats must be (m, wtot) and u0 one element")
        lib = _lib()
        stream = _stream(dev)
        ctr, status, vals = _pass1_scratch(dev, stream.value,
                                           -(-n // (_P1_THREADS * PASS1_PER_THREAD)))
        st = torch.empty(n, dtype=torch.int32, device=dev)
        err = lib.pass1_launch(log_w.data_ptr(), n, stats.data_ptr(),
                               u0.data_ptr(), _flag_ptr(flag, dev), ctr.data_ptr(),
                               status.data_ptr(), vals.data_ptr(), st.data_ptr(),
                               stream)
        _raise_on(err, "pass1_scan_kernel")
    LAUNCHES["pass1"] += 1
    return st


def resample_pass2(st: torch.Tensor, states: torch.Tensor,
                   flag=None, impl: str = "scatter") -> torch.Tensor:
    """The resampled values (n,) float32 in the layout of ``impl`` (module
    docstring): the kernel on CUDA tensors, the plain version on CPU
    tensors.  Where ``flag`` is 0, a copy of ``states``."""
    dev = states.device
    _check_impl(impl, states.shape[0])
    if dev.type == "cpu":
        return resample_pass2_plain(st, states, flag, impl)
    with span("launch.pass2_tile_kernel"):
        _cuda_inputs("resample_pass2", (states, "states", torch.float32),
                     (st, "st", torch.int32))
        n = states.shape[0]
        _check_n(n)
        if st.shape != states.shape:
            raise ValueError("st must have the shape of states")
        lib = _lib()
        out = torch.empty_like(states)
        err = lib.pass2_tile_launch(st.data_ptr(), states.data_ptr(), n,
                                    _flag_ptr(flag, dev), int(impl == "merge"),
                                    out.data_ptr(), _stream(dev))
        _raise_on(err, "pass2_tile_kernel")
    LAUNCHES["pass2" if impl == "scatter" else f"pass2_{impl}"] += 1
    return out


def streaming_available(n: int) -> bool:
    """Whether the epoch takes a population of ``n`` particles (the kernels
    mask a ragged last tile, so any n below 2^31)."""
    return 0 < n < 2 ** 31


def streaming_systematic_resample_values(key: torch.Generator,
                                         log_weights: torch.Tensor,
                                         states: torch.Tensor, *,
                                         stats=None, flag=None,
                                         impl: str = "scatter"):
    """Systematic resampling of a scalar float32 population; returns the
    new values in the layout of ``impl`` (:func:`resample_pass2`).  ``key``
    draws the comb offset (float64, on the device); ``stats``: precomputed
    :func:`logsumexp_stats`; ``flag``: see the module docstring."""
    _check_impl(impl, states.shape[0])
    u0 = torch.rand((), generator=key, device=states.device, dtype=torch.float64)
    if stats is None:
        stats = logsumexp_stats(log_weights, flag)
    st = resample_pass1(u0, log_weights, stats, flag)
    return resample_pass2(st, states, flag, impl)
