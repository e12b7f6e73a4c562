"""Inference engines: SIS, SMC, its resamplers, guided SMC, CSIS with its
dynamic-structure twin, and the gradient-based and second-level engines
(HMC, ChEES, NUTS, SVI, predictive sampling, the tempered SMC sampler,
particle Gibbs, SMC²)."""

from .chees import chees_hmc
from .csis import CSIS
from .csis_dynamic import DynamicCSIS, sis_host
from .hmc import HMCResult, hmc
from .nuts import nuts
from .particle_gibbs import CSMCResult, csmc_sweep, particle_gibbs
from .potential import FlatModel, flatten_model
from .predictive import posterior_predictive, prior_predictive
from .resampling import (
    ess,
    get_resampler,
    multinomial_resample,
    residual_resample,
    stratified_resample,
    systematic_resample,
)
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
from .smc2 import ParamSSM, SMC2Result, smc2
from .smc_csis import guide_ssm, train_ssm_proposal
from .smc_sampler import TemperedSMCResult, smc_sampler
from .svi import SVIResult, svi

__all__ = ["CSIS", "DynamicCSIS", "sis_host", "sis", "sis_streaming", "sis_streaming_checkpointed",
           "make_particle_fn", "make_prior_fn", "ImportanceResult", "StreamingResult",
           "StateSpaceModel", "SMCResult", "smc", "build_smc_run", "ess",
           "get_resampler", "systematic_resample", "stratified_resample",
           "multinomial_resample", "residual_resample", "train_ssm_proposal",
           "guide_ssm", "smc_sampler", "smc2", "ParamSSM", "SMC2Result",
           "TemperedSMCResult", "csmc_sweep", "particle_gibbs", "CSMCResult",
           "hmc", "chees_hmc", "nuts", "HMCResult", "svi", "SVIResult",
           "flatten_model", "posterior_predictive", "prior_predictive", "FlatModel"]
