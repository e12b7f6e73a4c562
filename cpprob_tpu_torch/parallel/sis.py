"""Mesh-sharded SIS — counterpart of ``cpprob_tpu/parallel/sis.py``.

Each rank runs the single-device particle program (``inference/sis.py``:
:func:`make_particle_fn` under ``torch.func.vmap``) on its ``N / k``
particles, drawing from a generator seeded from (seed, rank); no data
crosses the mesh until a statistic of the result is asked for, and then
the weighted-moment sums ride ``psum``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..inference.sis import ImportanceResult, _generator, _vmapped, make_particle_fn
from ..util.seeds import derive_seed
from ._collectives import all_gather, axis_index, axis_size, psum
from .mesh import particle_mesh, rank_device
from .resampling import _weighted_mean, global_ess, global_log_mean_exp

__all__ = ["sis_sharded", "ShardedImportanceResult"]

_SIS_TAG = 3_000_000


@dataclasses.dataclass(frozen=True)
class ShardedImportanceResult(ImportanceResult):
    """This rank's particles (``log_weights``, ``predicts``: its shard) and
    the statistics of the whole population: ``num_particles``,
    ``log_evidence`` (float64), ``ess`` (float64), ``mean``, ``variance``
    and ``normalized_weights`` (this shard's slice of the global ones) are
    reduced over the mesh and the same on every rank, and ``empirical``
    gathers the whole population.  Each statistic is a collective: every
    rank asks for the same ones in the same order.

    Deviation: the reference returns the global (N,) arrays in
    ``log_weights`` and ``predicts``; here they hold this rank's (N/k,)
    shard, so that no statistic moves the population unless asked."""

    mesh: Any = dataclasses.field(default=None, compare=False)

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0] * axis_size(self.mesh)

    @property
    def normalized_weights(self) -> torch.Tensor:
        lse = global_log_mean_exp(self.log_weights, self.mesh) + math.log(self.num_particles)
        return torch.exp(self.log_weights.double() - lse)

    @property
    def log_evidence(self) -> torch.Tensor:
        return global_log_mean_exp(self.log_weights, self.mesh)

    @property
    def ess(self) -> torch.Tensor:
        return global_ess(self.log_weights, self.mesh)

    def _moments(self, name: str):
        mean, w, total = _weighted_mean(self.predicts[name], self.log_weights, self.mesh)
        sq = psum(torch.sum(w * (self.predicts[name] - mean) ** 2, 0).reshape(-1), self.mesh)
        return mean, (sq / total).reshape(mean.shape)

    def mean(self, name: str) -> torch.Tensor:
        return self._moments(name)[0]

    def variance(self, name: str) -> torch.Tensor:
        return self._moments(name)[1]

    def empirical(self, name: str):
        """The whole population's weighted draws of ``name``, what the
        reference's global ``empirical(name)`` returns: every rank's shard
        of the predicts and the log-weights, all-gathered in mesh order (a
        collective; the same on every rank)."""
        from ..postprocess import EmpiricalDistribution

        vals = self.predicts[name]
        return EmpiricalDistribution(
            all_gather(vals, self.mesh).reshape((-1,) + tuple(vals.shape[1:])),
            all_gather(self.log_weights, self.mesh).reshape(-1))


def sis_sharded(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key,
    *,
    mesh=None,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    donate: bool = True,
) -> ShardedImportanceResult:
    """SIS with the particles sharded over ``mesh`` (default:
    ``particle_mesh()``, CUDA ranks).  ``n_particles`` must divide by the
    mesh size.  ``key``: an integer seed (or a generator, whose initial
    seed is taken); rank r draws its particles from a generator on its
    device seeded from (seed, r).  ``donate`` is kept for the reference's
    surface and does nothing."""
    mesh = particle_mesh() if mesh is None else mesh
    k = axis_size(mesh)
    if n_particles % k != 0:
        raise ValueError(f"n_particles={n_particles} must be divisible by mesh size {k}")
    seed = key.initial_seed() if isinstance(key, torch.Generator) else int(key)
    gen = _generator(derive_seed(seed, _SIS_TAG, axis_index(mesh)), rank_device(mesh))
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    log_w, predicts = _vmapped(particle, gen, n_particles // k)
    return ShardedImportanceResult(log_w, predicts, mesh=mesh)
