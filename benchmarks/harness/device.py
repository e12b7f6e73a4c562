"""The card a run measures: its name and power limit as ``nvidia-smi``
reads them (a copy of the port's ``util/profiling.py``
``gpu_name_and_power``)."""

from __future__ import annotations

import subprocess


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the first card, or ``"unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unavailable"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unavailable"


def power_limit(name_and_power: str) -> str:
    """The power limit out of ``name, power.limit`` (``"unavailable"``)."""
    parts = name_and_power.rsplit(",", 1)
    return parts[1].strip() if len(parts) == 2 else "unavailable"
