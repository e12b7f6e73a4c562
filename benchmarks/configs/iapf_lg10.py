"""``iapf_lg10`` as the port runs it: ``linear_gaussian_nd_ssm(A)`` for the
iterated APF's d = 10 transition, the user-physics kernel over 10 state and
10 observation planes (``attach_fused_vector_kernels``), launched for one
step with the step's resample control (``user_chunk_kernel``), and the
streaming resample epoch over rows of 10 floats; and the work of its
launches and its epochs by the frozen yardstick.

The physics of one particle-step, counted from the step the port renders
(``models/linear_gaussian.py`` ``nd_step_elem``: one rounded operation an
``__fadd_rn``/``__fsub_rn``/``__fmul_rn``) and the kernel's weight update:
the transition's d^2 products and d^2 sums (d - 1 a row, and its draw),
the emission's d differences, d squares, d - 1 sums, a scale and its
constant, and the weight's sum: 2 d^2 + 3 d + 2, 232 at d = 10.
"""

import json
from pathlib import Path

from harness import yardstick

HERE = Path(__file__).resolve().parent
# the name of the step kernel in the device trace
CHUNK_KERNEL = "user_chunk_kernel"


def _config():
    with open(HERE / "iapf_lg10.json") as f:
        return json.load(f)


def model(traffic):
    """The port's state-space model for this configuration: A_ij =
    alpha^(|i-j|+1) as the port builds it (``iapf_transition``)."""
    from cpprob_tpu_torch.models.linear_gaussian import (
        iapf_transition,
        linear_gaussian_nd_ssm,
    )

    if traffic.get("island_every"):
        raise ValueError("iapf_lg10 has no island checks")
    cfg = _config()
    return linear_gaussian_nd_ssm(iapf_transition(int(cfg["state_dim"]), float(cfg["alpha"])))


def physics_ops(cfg):
    """Rounded float32 operations of one particle-step's physics and weight
    update (the module docstring)."""
    d, dy = int(cfg["state_dim"]), int(cfg["obs_dim"])
    return 2 * d * d + 3 * dy + 2


def chunk_launch_bounds(cfg, traffic, n, steps_per_launch):
    """The frozen bound of each step-kernel launch of a query: 8 (d + 1) B
    a particle; per particle-step and plane half a Box-Muller pair and its
    Philox call, and the physics."""
    d = int(cfg["state_dim"])
    return [yardstick.normal_chunk_bound(n, s, D=d, physics_ops=physics_ops(cfg))
            for s in steps_per_launch]


def step_work(cfg):
    """The work of each particle-step of a series: d normal draws and the
    physics (the first step's draw from the prior and its weight counted
    alike)."""
    d = int(cfg["state_dim"])
    return [yardstick.normal_step_work(d, physics_ops(cfg))
            for _ in range(int(cfg["series_length"]))]


def epoch_launch_bounds(cfg, traffic, n, resamples):
    """The frozen bound of a query's resample epochs, one a resample it
    performed: what the work needs whatever implements it, the weights read
    once and the d floats of each particle read once and written once,
    (4 + 8 d) B a particle (84 B at d = 10)."""
    d = int(cfg["state_dim"])
    return [yardstick.bound((4 + 8 * d) * n) for _ in range(int(resamples))]
