"""Inference engines (so far: SIS, SMC, its resamplers, guided SMC, and
CSIS with its dynamic-structure twin)."""

from .csis import CSIS
from .csis_dynamic import DynamicCSIS, sis_host
from .resampling import ess, get_resampler, systematic_resample
from .sis import (
    ImportanceResult,
    StreamingResult,
    make_particle_fn,
    make_prior_fn,
    sis,
    sis_streaming,
    sis_streaming_checkpointed,
)
from .smc import SMCResult, StateSpaceModel, build_smc_run, smc
from .smc_csis import guide_ssm, train_ssm_proposal

__all__ = ["CSIS", "DynamicCSIS", "sis_host", "sis", "sis_streaming", "sis_streaming_checkpointed",
           "make_particle_fn", "make_prior_fn", "ImportanceResult", "StreamingResult",
           "StateSpaceModel", "SMCResult", "smc", "build_smc_run", "ess",
           "get_resampler", "systematic_resample", "train_ssm_proposal",
           "guide_ssm"]
