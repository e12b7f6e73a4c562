"""cpprob_tpu_torch — the PyTorch + CUDA port of ``cpprob_tpu``.

It keeps the JAX package's sub-package layout and public names; its hot
loops are CUDA kernels written for Hopper (``ops/csrc``), each with a plain
PyTorch version that runs on the CPU.  Models are written for one particle
with ``sample`` / ``observe`` / ``predict`` and run over a population
under ``torch.func.vmap`` (``core/handlers.py``).  It never imports JAX.
Importing it makes PyTorch's first multi-threaded CPU ``exp`` of the
process (``util/cpu_math.py``), which can be wrong where every later one
is exact.
"""

from . import distributions, models, postprocess
from .core import (
    factor,
    guarded_rejection,
    handlers,
    metaobserve,
    observe,
    predict,
    rejection_sample,
    rejection_sampling,
    sample,
    scan_sites,
)
from .inference.csis import CSIS
from .inference.csis_dynamic import DynamicCSIS, sis_host
from .inference.hmc import hmc
from .inference.nuts import nuts
from .inference.particle_gibbs import particle_gibbs
from .inference.sis import ImportanceResult, sis
from .inference.smc import SMCResult, StateSpaceModel, build_smc_run, smc
from .inference.smc_sampler import smc_sampler
from .inference.svi import svi
from .postprocess import EmpiricalDistribution, StatsPrinter
from .util.cpu_math import warm_vector_math

warm_vector_math()

__all__ = [
    "sample",
    "observe",
    "predict",
    "factor",
    "metaobserve",
    "rejection_sampling",
    "guarded_rejection",
    "rejection_sample",
    "scan_sites",
    "handlers",
    "distributions",
    "models",
    "postprocess",
    "sis",
    "smc",
    "build_smc_run",
    "smc_sampler",
    "particle_gibbs",
    "CSIS",
    "DynamicCSIS",
    "sis_host",
    "hmc",
    "nuts",
    "svi",
    "ImportanceResult",
    "SMCResult",
    "StateSpaceModel",
    "EmpiricalDistribution",
    "StatsPrinter",
]
