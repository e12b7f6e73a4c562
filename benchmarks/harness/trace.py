"""The traced slice of a window: ``torch.profiler`` over a few queries,
the device's activity and the host's launch calls read from its trace.

The profiler records no kernel for the launches of the first ~1.3 ms of
its window, and now and then delivers only part of a window's device
events while its launch calls are all there (the port's ``chip_smoke.py``
``_device_profile``, whose handling this copies).  So a slice opens with
32 warm-up launches, a device sync and 20 ms of sleep, and counts only
what falls inside the ``bench.traced`` annotation that follows; a slice
whose kernels fall short of its launches by more than 10 % is taken again.
The trace is exported once to a fixed file under ``out/`` and rewritten
there trimmed: the counted device events and launch calls."""

from __future__ import annotations

import json
import time
from pathlib import Path

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.traced"


def short_name(name: str) -> str:
    """An operation's name without its return type, anonymous namespace
    and trailing parameter list, at most 96 characters."""
    s = name.strip()
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    s = s.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    return s.strip()[:96] or name[:96]


def is_launch(event: dict) -> bool:
    """A host call that launches device work: a kernel or a graph."""
    name = event.get("name", "")
    return (event.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("LaunchKernel" in name or name in ("cudaGraphLaunch", "cuGraphLaunch")))


class Trace:
    """What one traced slice shows: its window ``[lo, hi]`` in µs, the
    device events in it, the launch calls made in it and the host events
    that cover it."""

    def __init__(self, events: list):
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW]
        if not marks:
            raise ValueError(f"the trace holds no {WINDOW} annotation")
        self.lo = float(marks[0]["ts"])
        self.hi = self.lo + float(marks[0]["dur"])
        inside = lambda e: self.lo <= float(e["ts"]) <= self.hi
        self.launches = [e for e in events if is_launch(e) and inside(e)]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e and float(e["ts"]) < self.hi
                       and float(e["ts"]) + float(e["dur"]) > self.lo]
        launched = {e.get("args", {}).get("correlation") for e in self.launches}
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"
                        and e.get("args", {}).get("correlation") in launched]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
                     and float(e["ts"]) < self.hi
                     and float(e["ts"]) + float(e["dur"]) > self.lo
                     and e.get("name") != WINDOW]

    @property
    def complete(self) -> bool:
        return bool(self.kernels) and len(self.kernels) >= 0.9 * len(self.launches)

    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def _intervals(self):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return stats.union_length(self._intervals(), self.lo, self.hi) * 1e-6

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose names hold any of ``names``."""
        return sum(float(e["dur"]) for e in self.kernels
                   if any(n in e.get("name", "") for n in names)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time in the window, summed by name."""
        total: dict = {}
        for e in self.device:
            key = short_name(e.get("name", "?"))
            total[key] = total.get(key, 0.0) + float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """``[[label, seconds], ...]``: the longest stretches of the window
        in which the device ran nothing, each labelled by the host events
        that cover its middle, outermost first."""
        longest = sorted(stats.gaps(self._intervals(), self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:top]
        out = []
        for a, b in longest:
            mid = 0.5 * (a + b)
            cover = sorted((e for e in self.host
                            if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])),
                           key=lambda e: -float(e["dur"]))
            label = (" > ".join(short_name(e["name"]) for e in cover[-2:])
                     or "host: outside any operator")
            out.append([label, (b - a) * 1e-6])
        return out

    def trimmed(self) -> dict:
        keep = self.device + self.launches
        return {"traceEvents": [{k: (v[:96] if k == "name" else v) for k, v in e.items()}
                                for e in keep]}


def traced_slice(run_queries, n_queries: int, out_file: Path, attempts: int = 3):
    """Profile ``run_queries(n_queries)`` (device activity and the host's
    operators and launch calls) and return the slice's :class:`Trace`,
    taken again up to ``attempts`` times while the profiler delivers a
    partial window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    warm = torch.zeros(1, device="cuda")
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                warm.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
            with record_function(WINDOW):
                run_queries(n_queries)
                torch.cuda.synchronize()
        out_file.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_file))
        with open(out_file) as f:
            trace = Trace(json.load(f)["traceEvents"])
        if trace.complete:
            break
    with open(out_file, "w") as f:
        json.dump(trace.trimmed(), f)
    return trace
