"""Profiling helpers — counterpart of ``cpprob_tpu/util/profiling.py``.

``profile_trace`` wraps ``torch.profiler`` (the reference's
``jax.profiler`` wrapper); ``span`` marks the program's
layers in the profiler's trace while one records and cost one check
otherwise; ``counter_group`` and ``counters`` are the one registry of the
program's launch and host-read counters; ``StageTimer`` gives wall-clock
per-stage timing, fenced with
``torch.cuda.synchronize()`` so that queued device work lands in the stage
that queued it; ``env_versions`` stamps a measurement with the software
stack and the card.

The spans, each a ``user_annotation`` event of the trace on the clock of
the device's events (one query's spans lie inside its ``smc.run``):

- ``smc.run``: a whole query, ``run`` of ``inference.smc.build_smc_run``;
- ``smc.init``: the population's start (the fused init kernel, or the
  initial draws and first reweight);
- ``smc.chunk`` / ``smc.step``: one call of a chunked or a per-step loop
  body (boundary flag, ticks, evidence, the epoch, the kernel or the move);
- ``resample.epoch``: one continuous resample epoch
  (``inference.resampling.continuous_resample_values_lme``);
- ``launch.<kernel>``: one ctypes launch of a port kernel, its argument
  checks and output allocations included.
"""

from __future__ import annotations

import contextlib
import os
import platform
import subprocess
import time
from typing import Dict, Iterable

import torch
from torch._C._autograd import _profiler_enabled

__all__ = ["profile_trace", "span", "counter_group", "counters", "recorded_counts",
           "add_counts", "StageTimer", "env_versions", "gpu_name_and_power"]


class _NoSpan:
    """The span while no profiler records: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context that marks ``name`` (a fixed string) in the trace of a
    recording ``torch.profiler`` (``torch.profiler.record_function``), and
    the one shared no-op while none records."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


_COUNTERS: Dict[str, Dict[str, int]] = {}


def counter_group(name: str, keys: Iterable[str]) -> Dict[str, int]:
    """The registered dict of counters ``name``, each of ``keys`` from 0
    when first registered; callers increment its entries in place."""
    return _COUNTERS.setdefault(name, dict.fromkeys(keys, 0))


def counters() -> Dict[str, int]:
    """A flat snapshot of every registered counter, ``"group.key": n``."""
    return {f"{g}.{k}": v for g, group in _COUNTERS.items() for k, v in group.items()}


@contextlib.contextmanager
def recorded_counts():
    """Yields a dict that, when the block ends, holds what the block added
    to each counter, ``{(group, key): n}``, and takes those additions back:
    a captured CUDA graph's launches count when it replays
    (:func:`add_counts`), not when it is captured."""
    before = {(g, k): v for g, group in _COUNTERS.items() for k, v in group.items()}
    added: Dict[tuple, int] = {}
    try:
        yield added
    finally:
        for g, group in _COUNTERS.items():
            for k, v in group.items():
                if v != before.get((g, k), 0):
                    added[(g, k)] = v - before.get((g, k), 0)
                    group[k] = before.get((g, k), 0)


def add_counts(added: Dict[tuple, int]) -> None:
    """Add ``{(group, key): n}`` (:func:`recorded_counts`) to the counters."""
    for (g, k), n in added.items():
        _COUNTERS[g][k] += n


def gpu_name_and_power() -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card), or ``"unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unavailable"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unavailable"


def env_versions() -> Dict[str, str]:
    """Version stamp for measurements: torch, CUDA, numpy and python
    versions, the device, and the card's name and power limit."""
    import numpy

    cuda = torch.cuda.is_available()
    name_power = gpu_name_and_power() if cuda else "unavailable"
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "numpy": numpy.__version__,
        "python": platform.python_version(),
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": str(torch.cuda.device_count() if cuda else 0),
        "nvidia_smi_name_power_limit": name_power,
    }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (the CPU,
    and the card where there is one) and write it to ``log_dir`` as a
    Chrome trace (``trace.json``).  Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock per named stage; ``sync=True`` fences the
    device with ``torch.cuda.synchronize()`` before reading the clock."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """JSON-friendly per-stage breakdown."""
        return {
            name: {
                "total_s": total,
                "calls": self.counts[name],
                "mean_ms": total / self.counts[name] * 1e3,
            }
            for name, total in self.totals.items()
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24}{total:>10.3f}{n:>8}{total / n * 1e3:>10.2f}"
            )
        return "\n".join(lines)
