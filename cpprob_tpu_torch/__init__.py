"""cpprob_tpu_torch — the PyTorch + CUDA port of ``cpprob_tpu``.

It keeps the JAX package's sub-package layout and public names; its hot
loops are CUDA kernels written for Hopper (``ops/csrc``), each with a plain
PyTorch version that runs on the CPU.  It never imports JAX.  Importing
it makes PyTorch's first multi-threaded CPU ``exp`` of the process
(``util/cpu_math.py``), which can be wrong where every later one is exact.
"""

from . import models
from .inference.smc import SMCResult, StateSpaceModel, build_smc_run, smc
from .util.cpu_math import warm_vector_math

warm_vector_math()

__all__ = ["StateSpaceModel", "SMCResult", "smc", "build_smc_run", "models"]
