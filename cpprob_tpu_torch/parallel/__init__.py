"""Multi-device execution — counterpart of ``cpprob_tpu/parallel``:
sharded SIS and SMC and distributed resampling over a particle mesh.

The reference is one ``shard_map`` program over a ``jax.sharding.Mesh``;
here every rank is a process under ``torch.distributed`` (one a device),
the mesh is a ``DeviceMesh`` over the default process group, and the
engines call explicit collectives on it (``_collectives.py``).  CPU ranks
talk over gloo, CUDA ranks over NCCL; ranks sharing one card take gloo.
"""

from .mesh import (
    PARTICLE_AXIS,
    particle_mesh,
    particle_sharding,
    replicated_sharding,
)
from .resampling import (
    global_ess,
    global_log_mean_exp,
    local_systematic_ancestors,
    ring_systematic_resample,
    sharded_systematic_ancestors,
)
from .distributed import initialize_multihost, is_multihost, virtual_devices
from .sis import sis_sharded
from .smc import ShardedSMCResult, smc_sharded

__all__ = [
    "initialize_multihost",
    "is_multihost",
    "virtual_devices",
    "PARTICLE_AXIS",
    "particle_mesh",
    "particle_sharding",
    "replicated_sharding",
    "sis_sharded",
    "smc_sharded",
    "ShardedSMCResult",
    "global_ess",
    "global_log_mean_exp",
    "ring_systematic_resample",
    "sharded_systematic_ancestors",
    "local_systematic_ancestors",
]
