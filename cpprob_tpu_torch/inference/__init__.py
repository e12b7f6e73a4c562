"""Inference engines (this slice: SMC and its resamplers)."""

from .resampling import ess, get_resampler, systematic_resample
from .smc import SMCResult, StateSpaceModel, build_smc_run, smc

__all__ = ["StateSpaceModel", "SMCResult", "smc", "build_smc_run", "ess",
           "get_resampler", "systematic_resample"]
