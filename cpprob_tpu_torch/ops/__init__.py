"""Hand-written kernels for the SMC hot loops, each beside its plain
PyTorch version: :mod:`.fused_hmm` (K-state HMM chains, CUDA),
:mod:`.fused_lg` (the linear-Gaussian model, CUDA), :mod:`.stream_resample`
(the continuous resample epoch, CUDA), :mod:`.user_chunk` (user physics,
CUDA generated from the model's function, :mod:`.render`), :mod:`.guided_tc`
and :mod:`.guided_scalar` (the guided scalar model, CUDA generated per net);
:mod:`.fused_ssm` builds models on them and :mod:`.population` launches the
population kernels."""
