"""``hmm3`` as the port runs it: the fused 3-state HMM of
``make_fused_hmm_ssm`` (init kernel, chunk kernel ``hmm_chunk_kernel<3>``
launched for a chunk or for one step, exchange resampling), and the work
its chunk kernel's launches need by the frozen yardstick."""

from harness import yardstick


def model(traffic):
    """The port's state-space model for this configuration, with the
    traffic's island checks (``island_every``, 0 for none)."""
    from cpprob_tpu_torch.ops.fused_hmm import make_fused_hmm_ssm

    return make_fused_hmm_ssm(island_every=int(traffic.get("island_every", 0)))


# the name of the chunk kernel in the device trace
CHUNK_KERNEL = "hmm_chunk_kernel"


def chunk_launch_bounds(cfg, traffic, n, steps_per_launch):
    """The frozen bound of each chunk-kernel launch of a query, given the
    steps each launch runs: a check of every island each ``island_every``
    interior steps."""
    K, every = int(cfg["states"]), int(traffic.get("island_every", 0))
    return [yardstick.chain_chunk_bound(
                n, K, s, (s - 1) // every if every else 0)
            for s in steps_per_launch]


def step_work(cfg):
    """The work of each particle-step of a series: the init draw, then a
    transition draw and reweight a step."""
    K, T = int(cfg["states"]), int(cfg["series_length"])
    return [yardstick.chain_step_work(K, t == 0) for t in range(T)]
