"""The general traffic generator: one client in a closed loop of SMC
queries, every parameter read from the traffic mix's data file.

A mix names ``particles`` (N), ``chunk`` (steps a kernel launch; 1 runs
the per-step path), ``ess_threshold``, ``island_every`` (where the model
has islands), ``pool`` and ``pool_seed`` (observation series drawn at
set-up by the configuration's reference from the mix's own fixed seed, so
that every run offers the same series), ``filter_every`` (one query in
that many has its final population summarized for the check) and
``trace_queries`` (the queries the traced slice covers).  The run's seed
orders the pool (query ``q`` runs series ``order[q mod pool]``) and gives
each query a particle seed that is a fixed function of it and ``q``, so
the same seed gives the same inputs and every seed the same work."""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
# set-up's queries: the first builds and loads the kernels, the second is warm
WARM_QUERIES = 2
_POOL_TAG, _QUERY_TAG, _SAMPLE_TAG, _ORDER_TAG = (
    0x5EED_0001, 0x5EED_0002, 0x5EED_0003, 0x5EED_0004)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _word(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([int(seed) & _MASK64, tag])
               .generate_state(1, np.uint64)[0])


class Plan:
    """The inputs of one run, drawn from ``seed``: the pool of series, and
    for each query its series, its particle seed and whether its final
    population is summarized."""

    def __init__(self, traffic: dict, config: dict, reference, seed: int):
        self.traffic, self.seed = traffic, int(seed)
        self.n = int(traffic["particles"])
        self.chunk = int(traffic["chunk"])
        self.ess_threshold = float(traffic["ess_threshold"])
        self.pool_size = int(traffic["pool"])
        self.filter_every = int(traffic["filter_every"])
        self.trace_queries = int(traffic["trace_queries"])
        rng = np.random.default_rng(np.random.SeedSequence(
            [int(traffic["pool_seed"]) & _MASK64, _POOL_TAG]))
        self.pool = reference.simulate(rng, self.pool_size, config)
        self.T = self.pool.shape[1]
        self.order = np.random.default_rng(np.random.SeedSequence(
            [self.seed & _MASK64, _ORDER_TAG])).permutation(self.pool_size)
        self._base = _word(self.seed, _QUERY_TAG)
        self._offset = _word(self.seed, _SAMPLE_TAG) % self.filter_every

    def series(self, q: int) -> int:
        return int(self.order[q % self.pool_size])

    def particle_seed(self, q: int) -> int:
        """A 63-bit seed for query ``q`` (warm-up queries take negative
        ``q``)."""
        return _splitmix64((self._base + q) & _MASK64) >> 1

    def sampled(self, q: int) -> bool:
        """Whether query ``q``'s final population is summarized."""
        return q % self.filter_every == self._offset

    def steps_per_launch(self) -> list:
        """The steps each chunk-kernel launch of a query runs: the
        ``T - 1`` steps after the first observation in chunks."""
        rest = self.T - 1
        return [min(self.chunk, rest - s) for s in range(0, rest, self.chunk)]
