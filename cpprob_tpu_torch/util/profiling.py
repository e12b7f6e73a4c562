"""Profiling helpers — counterpart of ``cpprob_tpu/util/profiling.py``.

``profile_trace`` wraps ``torch.profiler`` (the reference's
``jax.profiler`` wrapper); ``StageTimer`` gives wall-clock per-stage
timing, fenced with
``torch.cuda.synchronize()`` so that queued device work lands in the stage
that queued it; ``env_versions`` stamps a measurement with the software
stack and the card.
"""

from __future__ import annotations

import contextlib
import os
import platform
import subprocess
import time
from typing import Dict

import torch

__all__ = ["profile_trace", "StageTimer", "env_versions", "gpu_name_and_power"]


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
