"""Model zoo — counterpart of ``cpprob_tpu/models`` (the reference's
``include/models`` / ``src/models``): the trace-form models, run by SIS,
and the state-space models, run by SMC, each with its exact numpy oracle,
and the SHERPA-family physics models (``models/sherpa.py``)."""

from .all_distr import all_distr
from .gaussian import (
    Gauss,
    gaussian_2d_unknown_mean,
    gaussian_posterior_analytic,
    gaussian_unknown_mean,
    gaussian_unknown_mean_readme,
)
from .hmm import (
    HMM_MEANS,
    HMM_TRANS,
    hmm,
    hmm_exact_posterior,
    hmm_log_evidence,
    hmm_scan,
    hmm_ssm,
    simulate_observations,
)
from .linear_gaussian import (
    kalman_filter_1d,
    linear_gaussian_1d,
    linear_gaussian_ssm,
)
from .poly import (
    eval_poly,
    generate_polynomial,
    linear_regression,
    poly_adjustment,
    poly_adjustment_prior_gen,
)
from .rejection import (
    normal_rejection_sampling,
    normal_rejection_sampling_guard,
)
from .sherpa import (
    CHANNEL_MOMENTA,
    calo_simulation,
    sherpa_calorimeter_wrapper,
    sherpa_mini,
    sherpa_mini_wrapper,
)

__all__ = [
    "all_distr",
    "Gauss",
    "gaussian_unknown_mean",
    "gaussian_unknown_mean_readme",
    "gaussian_2d_unknown_mean",
    "gaussian_posterior_analytic",
    "hmm",
    "hmm_scan",
    "hmm_ssm",
    "hmm_exact_posterior",
    "hmm_log_evidence",
    "simulate_observations",
    "HMM_MEANS",
    "HMM_TRANS",
    "linear_gaussian_1d",
    "linear_gaussian_ssm",
    "kalman_filter_1d",
    "poly_adjustment",
    "linear_regression",
    "generate_polynomial",
    "eval_poly",
    "poly_adjustment_prior_gen",
    "normal_rejection_sampling",
    "normal_rejection_sampling_guard",
    "sherpa_mini",
    "sherpa_mini_wrapper",
    "calo_simulation",
    "sherpa_calorimeter_wrapper",
    "CHANNEL_MOMENTA",
]
