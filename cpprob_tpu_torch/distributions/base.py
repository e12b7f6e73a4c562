"""The distribution protocol — counterpart of
``cpprob_tpu/distributions/base.py``.

A distribution is a frozen dataclass whose fields are tensors (its
parameters) or nested distributions, with methods:

- ``sample(generator, sample_shape=())``: a draw from the explicit
  ``torch.Generator`` (the JAX key's counterpart; nothing uses torch's
  global generator).  It draws on the generator's device and raises if
  that is not the distribution's.
- ``log_prob(x)``, and ``cdf(x)``, ``icdf(u)``, ``mean`` and ``variance``
  where the reference has them.  They branch on no tensor's value and read
  none back to the host, so they never synchronise with the card and they
  run under ``torch.func.vmap``.

A distribution lives where its tensor parameters are.  Python numbers,
lists and numpy arrays among its parameters become tensors on ``device=``,
or on the device of its tensor parameters and nested distributions where
it has any; parameters on two devices raise.  ``device=`` defaults to
:func:`default_device`: the device of the innermost
:class:`~cpprob_tpu_torch.core.handlers.Seed`'s generator while a handled
model runs, ``"cuda"`` otherwise (as the interop helpers').  Nothing moves
to the CPU when no card is found.  Host values reach the card without a
synchronisation (:func:`to_device`).  Discrete draws are int64, torch's
index type (the reference's are int32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..util.ndarray import to_host
from ..util.profiling import counter_group

__all__ = [
    "Distribution",
    "dist_dataclass",
    "promote_to_result_dtype",
    "default_device",
    "to_device",
    "to_host",
    "host_any",
    "host_item",
]

# host reads of a flag by :func:`host_any`, by caller: each is one
# synchronisation with the card (an external simulator's exchange, which
# copies the population's inputs to the host; the rejection rounds; NUTS's
# doublings and leapfrog steps; the tempered sampler's stages; SMC²'s
# rejuvenation test; the sharded SMC's resample flag at a step or chunk
# boundary and the balanced scheme's fit check in an epoch that fires)
HOST_READS = counter_group("host_reads", (
    "observe_external", "rejection_sample", "truncated", "nuts", "smc_sampler", "smc2",
    "smc_sharded"))


def default_device() -> torch.device:
    """The device that numbers and host arrays go to: the innermost
    ``Seed``'s generator's while a handled model runs, else ``"cuda"``."""
    from ..core.handlers import current_device   # core imports this module

    dev = current_device()
    return torch.device("cuda") if dev is None else dev


def to_device(v, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(v, dtype, device)`` that never waits on the card:
    a Python number is filled in place on the device, and host data is
    copied from pinned memory without blocking (``torch.as_tensor`` of host
    data onto the card synchronises with it)."""
    device = torch.device(device)
    if isinstance(v, torch.Tensor) and v.device == device:
        return v if dtype is None else v.to(dtype)
    if isinstance(v, (bool, int, float)) and not isinstance(v, np.generic):
        return torch.full((), v, dtype=dtype, device=device)
    host = torch.as_tensor(v, dtype=dtype)
    if device.type == "cuda" and host.device.type == "cpu":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def host_any(flag: torch.Tensor, caller: str) -> bool:
    """Whether any element of ``flag`` is true, over every particle of an
    enclosing ``torch.func.vmap`` too: the batched tensor is unwrapped, so
    this is one reduction over the whole population and one host read.  It
    is the one synchronisation a rejection round makes; it is counted in
    ``HOST_READS[caller]`` and allowed under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from torch._C import _functorch

    while _functorch.is_batchedtensor(flag):
        flag = _functorch.get_unwrapped(flag)
    return bool(host_item(flag.any(), caller))


def host_item(x: torch.Tensor, caller: str):
    """``x.item()`` of a one-element tensor: one host read, counted in
    ``HOST_READS[caller]`` and allowed under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    HOST_READS[caller] += 1
    if x.device.type != "cuda":
        return x.item()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return x.item()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static"))


def _param_fields(dist):
    """The fields of ``dist`` that hold parameters (not static ones, not
    ``device``)."""
    return [f for f in dataclasses.fields(dist) if f.name != "device" and not _is_static(f)]


def _place(self):
    """``__post_init__`` of a :func:`dist_dataclass`: settles the device and
    turns numbers and numpy arrays into tensors there."""
    devices = set()
    for f in _param_fields(self):
        v = getattr(self, f.name)
        if isinstance(v, (torch.Tensor, Distribution)) and getattr(v, "device", None):
            devices.add(v.device)
    if len(devices) > 1:
        raise ValueError(f"{type(self).__name__}: parameters on several devices "
                         f"{sorted(map(str, devices))}")
    if devices:
        dev = devices.pop()
    else:
        dev = default_device() if self.device is None else self.device
        dev = torch.empty(0, device=dev).device
    object.__setattr__(self, "device", dev)
    for f in _param_fields(self):
        v = getattr(self, f.name)
        if not isinstance(v, (torch.Tensor, Distribution)):
            if isinstance(v, (np.ndarray, list, tuple)) or np.isscalar(v):
                object.__setattr__(self, f.name, to_device(v, dev))


def dist_dataclass(cls):
    """Decorator: a frozen dataclass whose parameter fields become tensors
    on one device (the module docstring), with a keyword-only ``device``
    field.  Mark fields that are not parameters with
    ``dataclasses.field(metadata=dict(static=True))``."""
    cls.__annotations__ = {**cls.__dict__.get("__annotations__", {}), "device": Any}
    cls.device = dataclasses.field(default=None, kw_only=True,
                                   metadata=dict(static=True))
    cls.__post_init__ = _place
    return dataclasses.dataclass(frozen=True)(cls)


class Distribution:
    """Abstract base.  Subclasses are :func:`dist_dataclass` classes.

    ``event_ndim``: number of trailing dimensions of a single draw (0 for
    scalar distributions, 1 for vector distributions such as the diagonal
    MVN).
    """

    event_ndim: int = 0
    # Discrete distributions return integer draws; continuous ones float.
    is_discrete: bool = False

    # -- shape helpers --------------------------------------------------
    @property
    def batch_shape(self) -> Tuple[int, ...]:
        shapes = [tuple(t.shape) for t in _leaves(self)]
        if not shapes:
            return ()
        result = tuple(torch.broadcast_shapes(*shapes))
        if self.event_ndim:
            result = result[: len(result) - self.event_ndim] if len(result) >= self.event_ndim else ()
        return result

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    # -- core API -------------------------------------------------------
    def sample(self, generator: torch.Generator,
               sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, x: Any) -> torch.Tensor:
        raise NotImplementedError

    def cdf(self, x: Any) -> torch.Tensor:  # optional
        raise NotImplementedError(f"{type(self).__name__} has no cdf")

    # Moments (used by postprocess + tests); optional.
    @property
    def mean(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def variance(self) -> torch.Tensor:
        raise NotImplementedError

    # -- helpers for the subclasses --------------------------------------
    def _device_of(self, generator: torch.Generator) -> torch.device:
        """The device a draw from ``generator`` goes to: this
        distribution's, which must be the generator's (a generator made
        with ``device="cuda"`` names no index: it draws on the current
        card)."""
        g = generator.device
        if g.type != self.device.type or (g.index is not None
                                          and g.index != self.device.index):
            raise ValueError(f"{type(self).__name__} lives on {self.device}; the "
                             f"generator draws on {g}")
        return self.device

    def _as(self, x, dtype=None) -> torch.Tensor:
        """``x`` as a tensor on this distribution's device (``dtype`` if
        given)."""
        return to_device(x, self.device, dtype)


def _leaves(dist):
    """The parameter tensors of ``dist``, nested distributions' included."""
    out = []
    for f in _param_fields(dist):
        v = getattr(dist, f.name)
        if isinstance(v, Distribution):
            out.extend(_leaves(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def map_params(dist, fn):
    """``dist`` with ``fn`` applied to every parameter tensor, nested
    distributions' included (the counterpart of ``jax.tree_util.tree_map``
    over a distribution)."""
    changes = {}
    for f in _param_fields(dist):
        v = getattr(dist, f.name)
        if isinstance(v, Distribution):
            changes[f.name] = map_params(v, fn)
        elif isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
    return dataclasses.replace(dist, **changes)


def promote_to_result_dtype(*arrays):
    """Promote parameters to one floating dtype: float32, unless one is
    float64."""
    dtype = torch.float32
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.dtype == torch.float64:
            dtype = torch.float64
    return tuple(torch.as_tensor(a, dtype=dtype) for a in arrays)
