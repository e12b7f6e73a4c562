"""The streaming systematic resample epoch for scalar float32 populations —
counterpart of ``cpprob_tpu/ops/pallas_resample.py``.

CUDA C++ in ``csrc/stream_resample.cu``; each wrapper has a plain PyTorch
twin, which it runs on CPU tensors only (on CUDA tensors it launches the
kernel or raises):

- :func:`logsumexp_stats` (K14, <- ``logsumexp_stats``): ``stats = (m,
  wtot)``, ``m = max(log_w)``, ``wtot = sum(exp(log_w - m))``, a float64
  (2,) tensor on the population's device.
- :func:`resample_pass1` (K15, <- ``_pass1``): the start slots
  ``st_j = ceil(n * cdf_{j-1} - u0)`` clipped to [0, n], int32, from the
  exclusive prefix of the normalised weights.
- :func:`resample_pass2` (K16, <- ``_streaming_resample(impl="scatter")``):
  slot ``i`` takes the value of the last particle ``j`` with ``st_j <= i``;
  the exact expansion of the start slots, slot ``i`` at position ``i``.

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

from .fused_hmm import _check, _raise_on, _stream

__all__ = [
    "LAUNCHES", "logsumexp_stats", "logsumexp_stats_plain", "resample_pass1",
    "resample_pass1_plain", "resample_pass2", "resample_pass2_plain",
    "streaming_available", "streaming_systematic_resample_values",
]

_THREADS = 256
_TILE = 4096            # particles per pass-1 tile (csrc/stream_resample.cu)

# kernel launches by wrapper, counted where each wrapper launches its kernels
LAUNCHES = {"lse_stats": 0, "pass1": 0, "pass2": 0}


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


def resample_pass2_plain(st: torch.Tensor, states: torch.Tensor,
                         flag=None) -> torch.Tensor:
    """The values of the expansion of the start slots ``st``; ``states``
    themselves where ``flag`` is 0."""
    slots = torch.arange(states.shape[0], dtype=st.dtype, device=st.device)
    owner = torch.searchsorted(st, slots, right=True) - 1
    out = states[torch.clamp(owner, min=0)]
    return out if flag is None else torch.where(flag.reshape(()) != 0, out, states)


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("stream_resample")
    if lib.pass1_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stream_tile.argtypes = []
        lib.stream_tile.restype = i
        lib.lse_stats_launch.argtypes = [p, ll, p, p, p, i, p, p]
        lib.lse_stats_launch.restype = i
        lib.pass1_launch.argtypes = [p, ll, p, p, p, p, p, p, p]
        lib.pass1_launch.restype = i
        lib.pass2_launch.argtypes = [p, p, ll, p, p, i, p]
        lib.pass2_launch.restype = i
        if lib.stream_tile() != _TILE:
            raise RuntimeError("csrc/stream_resample.cu tile differs from "
                               f"_TILE={_TILE}")
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


def _grid(dev, n: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-n // _THREADS), 8 * sms))


def _check_n(n: int):
    if not streaming_available(n):
        raise ValueError(f"the streaming epoch takes 0 < n < 2^31, got {n}")


def logsumexp_stats(log_w: torch.Tensor, flag=None) -> torch.Tensor:
    """(m, wtot) of ``log_w`` (n,) float32 as a float64 (2,) tensor: the
    kernel on a CUDA tensor (undefined where ``flag`` is 0), the plain
    version on a CPU tensor."""
    if log_w.device.type == "cpu":
        return logsumexp_stats_plain(log_w)
    dev = _cuda_inputs("logsumexp_stats", (log_w, "log_w", torch.float32))
    n = log_w.shape[0]
    _check_n(n)
    lib = _lib()
    grid = _grid(dev, n)
    rec_m = torch.empty(grid, dtype=torch.float32, device=dev)
    rec_s = torch.empty(grid, dtype=torch.float64, device=dev)
    stats = torch.empty(2, dtype=torch.float64, device=dev)
    err = lib.lse_stats_launch(log_w.data_ptr(), n, _flag_ptr(flag, dev),
                               rec_m.data_ptr(), rec_s.data_ptr(), grid,
                               stats.data_ptr(), _stream(dev))
    _raise_on(err, "lse_stats_kernel")
    LAUNCHES["lse_stats"] += 1
    return stats


def resample_pass1(u0, log_w: torch.Tensor, stats: torch.Tensor,
                   flag=None) -> torch.Tensor:
    """Start slots (n,) int32 for the comb offset ``u0`` (float64 scalar
    tensor on the population's device) and ``stats`` from
    :func:`logsumexp_stats`: the kernels on CUDA tensors (undefined where
    ``flag`` is 0), the plain version on CPU tensors."""
    dev = log_w.device
    u0 = torch.as_tensor(u0, dtype=torch.float64, device=dev)
    if dev.type == "cpu":
        return resample_pass1_plain(u0, log_w, stats)
    _cuda_inputs("resample_pass1", (log_w, "log_w", torch.float32),
                 (stats, "stats", torch.float64), (u0, "u0", torch.float64))
    n = log_w.shape[0]
    _check_n(n)
    if stats.shape != (2,) or u0.numel() != 1:
        raise ValueError("stats must be (m, wtot) and u0 one element")
    lib = _lib()
    n_tiles = -(-n // _TILE)
    tile_sum = torch.empty(n_tiles, dtype=torch.float64, device=dev)
    tile_off = torch.empty(n_tiles, dtype=torch.float64, device=dev)
    st = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.pass1_launch(log_w.data_ptr(), n, stats.data_ptr(),
                           u0.data_ptr(), _flag_ptr(flag, dev),
                           tile_sum.data_ptr(), tile_off.data_ptr(),
                           st.data_ptr(), _stream(dev))
    _raise_on(err, "pass1 kernels")
    LAUNCHES["pass1"] += 1
    return st


def resample_pass2(st: torch.Tensor, states: torch.Tensor,
                   flag=None) -> torch.Tensor:
    """The resampled values (n,) float32: the kernel on CUDA tensors, the
    plain version on CPU tensors.  Where ``flag`` is 0, a copy of
    ``states``."""
    dev = states.device
    if dev.type == "cpu":
        return resample_pass2_plain(st, states, flag)
    _cuda_inputs("resample_pass2", (states, "states", torch.float32),
                 (st, "st", torch.int32))
    n = states.shape[0]
    _check_n(n)
    if st.shape != states.shape:
        raise ValueError("st must have the shape of states")
    lib = _lib()
    out = torch.empty_like(states)
    err = lib.pass2_launch(st.data_ptr(), states.data_ptr(), n,
                           _flag_ptr(flag, dev), out.data_ptr(),
                           _grid(dev, n), _stream(dev))
    _raise_on(err, "pass2_kernel")
    LAUNCHES["pass2"] += 1
    return out


def streaming_available(n: int) -> bool:
    """Whether the epoch takes a population of ``n`` particles (the kernels
    mask a ragged last tile, so any n below 2^31)."""
    return 0 < n < 2 ** 31


def streaming_systematic_resample_values(key: torch.Generator,
                                         log_weights: torch.Tensor,
                                         states: torch.Tensor, *,
                                         stats=None, flag=None):
    """Systematic resampling of a scalar float32 population; returns the
    new values, slot ``i`` at position ``i``.  ``key`` draws the comb offset
    (float64, on the device); ``stats``: precomputed
    :func:`logsumexp_stats`; ``flag``: see the module docstring."""
    u0 = torch.rand((), generator=key, device=states.device, dtype=torch.float64)
    if stats is None:
        stats = logsumexp_stats(log_weights, flag)
    st = resample_pass1(u0, log_weights, stats, flag)
    return resample_pass2(st, states, flag)
