"""Hand-written CUDA kernels for the SMC hot loops, each beside its plain
PyTorch version: :mod:`.fused_hmm` (the HMM), :mod:`.fused_lg` (the
linear-Gaussian model) and :mod:`.stream_resample` (the continuous
resample epoch)."""
