"""Hand-written CUDA kernels for the SMC hot loops, each beside its plain
PyTorch version (see :mod:`.fused_hmm`)."""
