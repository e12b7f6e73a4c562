"""Posterior post-processing (counterpart of ``cpprob_tpu/postprocess``)."""

from .diagnostics import effective_sample_size, split_rhat, summarize_chains
from .empirical import EmpiricalDistribution
from .stats import StatsPrinter

__all__ = [
    "EmpiricalDistribution",
    "StatsPrinter",
    "split_rhat",
    "effective_sample_size",
    "summarize_chains",
]
