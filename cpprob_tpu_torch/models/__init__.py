"""Models (this slice: the 3-state HMM in state-space form)."""

from .hmm import (
    HMM_MEANS,
    HMM_TRANS,
    hmm_exact_posterior,
    hmm_log_evidence,
    hmm_ssm,
    simulate_observations,
)

__all__ = ["HMM_MEANS", "HMM_TRANS", "hmm_ssm", "hmm_exact_posterior",
           "hmm_log_evidence", "simulate_observations"]
