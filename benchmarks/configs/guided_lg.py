"""``guided_lg`` as the port runs it: the linear-Gaussian model under the
committed ``[3,64,64,2]`` proposal net, built the documented way,
``attach_fused_guided_scalar_kernels(linear_gaussian_ssm, net, T,
trans_logpdf_elem=..., obs_logpdf_elem=...)`` with the default ``mxu``: the
chunk kernel is K12's tensor-core twin ``guided_tc_kernel`` (its wide
layout), the resample epoch the streaming one; and the work its chunk
kernel's launches need by the frozen yardstick.

The work of one guided particle-step is counted as ``util/roofline.py``
``guided_tc_ops`` counts it (copied here, not imported): three TF32
multiply-adds a weight of the hidden->hidden layers (3xTF32, the fewest
that give float32-level products on the tensor cores); on the FMA pipe the
first layer (3 a unit), ReLU of the later hidden units (1 each), the
output layer (2 x 2 a weight) and the tail's 14; half a Philox call and a
Box-Muller pair; one exp + log1p pair (the softplus).  ``yardstick.bound``
takes the TF32 multiply-adds as such (``tf32_macs``).  ``sweep_bound``
takes no tensor-core count, so :func:`step_work` gives them as the float32
operations that take the same time at the published peaks (x 67e12 /
247.5e12), and, as the tensor cores and the FMA pipe run side by side,
gives a guided step the larger of the two pipes' work, not their sum: no
share reads over 100 % for any implementation of the function.
"""

import json
from pathlib import Path

from harness import yardstick

HERE = Path(__file__).resolve().parent
# the name of the chunk kernel in the device trace
CHUNK_KERNEL = "guided_tc_kernel"


def _config():
    with open(HERE / "guided_lg.json") as f:
        return json.load(f)


def _net():
    with open(HERE / "guided_lg_net.json") as f:
        return json.load(f)


def model(traffic):
    """The port's guided state-space model for this configuration: the
    committed net on the card (on the CPU where there is none)."""
    import numpy as np
    import torch

    from cpprob_tpu_torch.interop import mlp_params_from_numpy
    from cpprob_tpu_torch.models.linear_gaussian import (
        linear_gaussian_ssm,
        obs_logpdf_elem,
        trans_logpdf_elem,
    )
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels

    if traffic.get("island_every"):
        raise ValueError("guided_lg has no island checks")
    layers = [{"w": np.asarray(layer["w"], np.float32), "b": np.asarray(layer["b"], np.float32)}
              for layer in _net()["layers"]]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    params = mlp_params_from_numpy(layers, device=device)
    return attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, params, int(_config()["series_length"]),
        trans_logpdf_elem=trans_logpdf_elem, obs_logpdf_elem=obs_logpdf_elem)


def guided_ops(sizes):
    """Per guided particle-step: ``(tf32_macs, f32_ops)`` of a net of
    ``sizes`` (hidden widths padded to multiples of 8, as run)."""
    ps = [sizes[0], *(-(-h // 8) * 8 for h in sizes[1:-1]), sizes[-1]]
    hidden = ps[1:-1]
    macs = sum(a * b for a, b in zip(hidden[:-1], hidden[1:]))
    return 3 * macs, 3 * hidden[0] + sum(hidden[1:]) + 4 * hidden[-1] + 14


def chunk_launch_bounds(cfg, traffic, n, steps_per_launch):
    """The frozen bound of each chunk-kernel launch of a query: 16 B a
    particle; per particle-step the net, half a Box-Muller pair and its
    Philox call, and an exp + log1p pair."""
    tf32, f32 = guided_ops(cfg["net_sizes"])
    out = []
    for s in steps_per_launch:
        ps = n * s
        out.append(yardstick.bound(16 * n, ps * f32, tf32_macs=ps * tf32,
                                   philox_calls=ps / 2, normal_pairs=ps / 2,
                                   exp_log_pairs=ps))
    return out


def step_work(cfg):
    """The work of each particle-step of a series as ``sweep_bound`` takes
    it, (f32 operations, Philox calls, Box-Muller pairs): the first step a
    draw from the prior and a reweight (``lg1d``'s), each later one a
    guided move, the larger of its tensor-core work in float32-operation
    time and its FMA-pipe work (the draws included)."""
    tf32, f32 = guided_ops(cfg["net_sizes"])
    tc = tf32 * yardstick.F32_OPS_PER_S / yardstick.TC_TF32_MACS_PER_S
    fma = (f32 + yardstick.EXP_LOG_OPS
           + (yardstick.PHILOX_OPS + yardstick.BOX_MULLER_OPS) / 2)
    if tc > fma:
        guided = (tc, 0.0, 0.0)
    else:
        guided = (f32 + yardstick.EXP_LOG_OPS, 0.5, 0.5)
    T = int(cfg["series_length"])
    return [yardstick.normal_step_work()] + [guided] * (T - 1)
