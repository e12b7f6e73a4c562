"""Inference engines (so far: SMC, its resamplers, and guided SMC)."""

from .resampling import ess, get_resampler, systematic_resample
from .smc import SMCResult, StateSpaceModel, build_smc_run, smc
from .smc_csis import guide_ssm, train_ssm_proposal

__all__ = ["StateSpaceModel", "SMCResult", "smc", "build_smc_run", "ess",
           "get_resampler", "systematic_resample", "train_ssm_proposal",
           "guide_ssm"]
