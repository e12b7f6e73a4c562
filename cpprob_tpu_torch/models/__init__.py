"""Models in state-space form: the 3-state HMM and the linear-Gaussian
model, each with its exact numpy oracle."""

from .hmm import (
    HMM_MEANS,
    HMM_TRANS,
    hmm_exact_posterior,
    hmm_log_evidence,
    hmm_ssm,
    simulate_observations,
)
from .linear_gaussian import kalman_filter_1d, linear_gaussian_ssm

__all__ = ["HMM_MEANS", "HMM_TRANS", "hmm_ssm", "hmm_exact_posterior",
           "hmm_log_evidence", "simulate_observations", "linear_gaussian_ssm",
           "kalman_filter_1d"]
