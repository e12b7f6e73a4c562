"""Posterior statistics reporting — counterpart of
``cpprob_tpu/postprocess/stats.py`` (the reference's ``StatsPrinter``,
``stats_printer.hpp:25-120``): real predicts → weighted mean/variance;
integer predicts → normalized distribution table + MAP + point count.
The summary reads its numbers back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, TextIO

import numpy as np
import torch

from .empirical import EmpiricalDistribution

__all__ = ["StatsPrinter"]


class StatsPrinter:
    """Formats an :class:`~cpprob_tpu_torch.inference.sis.ImportanceResult`
    (or any object with ``predicts`` and ``log_weights``)."""

    def __init__(self, result):
        self.result = result

    @classmethod
    def from_dump(cls, path: str, native: Optional[bool] = None):
        """Build from a reference-format posterior dump on disk — the
        ``StatsPrinter{outfile}`` path (``stats_printer.hpp:25-40``): parse
        ``<path>.ids`` + ``.int``/``.real`` (the native C++ parser when its
        build loads, :func:`cpprob_tpu_torch.io.serialization.load_posterior`),
        then summarize; the tensors stay on the CPU, where the file was
        read and where the summary goes."""
        from ..inference.sis import ImportanceResult
        from ..io.serialization import load_posterior

        predicts, log_w = load_posterior(path, native=native)
        predicts = {k: torch.as_tensor(np.asarray(v)) for k, v in predicts.items() if len(v)}
        return cls(ImportanceResult(torch.as_tensor(np.asarray(log_w)), predicts))

    def summary(self) -> Dict[str, dict]:
        out = {}
        lw = self.result.log_weights
        for name, values in self.result.predicts.items():
            values = torch.as_tensor(values, device=lw.device)
            emp = EmpiricalDistribution(values, lw)
            if not values.dtype.is_floating_point:
                num_values = int(values.max()) + 1 if values.numel() else 1
                out[name] = {
                    "kind": "int",
                    "distribution": emp.distribution(num_values).cpu().numpy(),
                    "map": emp.map_estimate(num_values).cpu().numpy(),
                    "count": values.shape[0],
                }
            else:
                out[name] = {
                    "kind": "real",
                    "mean": emp.mean.cpu().numpy(),
                    "variance": emp.variance.cpu().numpy(),
                    "ess": float(emp.ess),
                    "count": values.shape[0],
                }
        return out

    def print(self, file: Optional[TextIO] = None) -> str:
        lines = []
        for name, s in self.summary().items():
            if s["kind"] == "real":
                lines.append(
                    f"{name}:\n  Mean: {s['mean']}\n  Variance: {s['variance']}\n"
                    f"  ESS: {s['ess']:.1f}  (n={s['count']})"
                )
            else:
                dist_str = np.array2string(s["distribution"], precision=5)
                lines.append(
                    f"{name}:\n  Distribution: {dist_str}\n  MAP: {s['map']}\n"
                    f"  (n={s['count']})"
                )
        text = "\n".join(lines)
        print(text, file=file)
        return text
