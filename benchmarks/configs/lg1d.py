"""``lg1d`` as the port runs it: ``make_fused_lg_ssm`` (the chunk kernel
``lg_chunk_kernel``, launched for a chunk or for one step, and the
streaming resample epoch), and the work its chunk kernel's launches need
by the frozen yardstick."""

from harness import yardstick


def model(traffic):
    """The port's state-space model for this configuration."""
    from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm

    if traffic.get("island_every"):
        raise ValueError("lg1d has no island checks")
    return make_fused_lg_ssm()


# the name of the chunk kernel in the device trace
CHUNK_KERNEL = "lg_chunk_kernel"


def chunk_launch_bounds(cfg, traffic, n, steps_per_launch):
    """The frozen bound of each chunk-kernel launch of a query."""
    return [yardstick.normal_chunk_bound(n, s) for s in steps_per_launch]


def step_work(cfg):
    """The work of each particle-step of a series: a normal draw and a
    reweight, the first from the prior."""
    return [yardstick.normal_step_work() for _ in range(int(cfg["series_length"]))]
