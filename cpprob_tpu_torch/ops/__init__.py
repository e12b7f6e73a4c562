"""Hand-written kernels for the SMC hot loops, each beside its plain
PyTorch version: :mod:`.fused_hmm` (K-state HMM chains, CUDA),
:mod:`.fused_lg` (the linear-Gaussian model, CUDA), :mod:`.stream_resample`
(the continuous resample epoch, CUDA) and :mod:`.triton_ssm` (user physics,
Triton); :mod:`.fused_ssm` builds models on them and :mod:`.population`
launches the population kernels."""
