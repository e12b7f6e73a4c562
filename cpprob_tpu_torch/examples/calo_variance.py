"""Per-voxel mean/variance study of the calorimeter simulator — counterpart
of ``examples/calo_variance.py`` (reference
``src/models/calo_variance.cpp:60-177``): run the calorimeter N times on a
fixed particle configuration, vmapped over the runs, and report voxel-wise
statistics (used in the reference to choose the ABC observation noise
scale).

    python -m cpprob_tpu_torch.examples.calo_variance -n 64
"""

import argparse

PARTICLES = [
    [1.0, 0.1, 3.0, 5.0, 0.2, 0.1, 211.0, 1.0],
    [0.5, -0.2, 2.0, 3.0, -0.1, 0.4, 11.0, 1.0],
]


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="calo_variance")
    ap.add_argument("-n", type=int, default=32, help="number of simulations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="npz output path")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cpprob_tpu_torch.core import handlers
    from cpprob_tpu_torch.models.sherpa import calo_simulation

    from ..util.device import resolve_device
    from ._common import to_np

    dev = resolve_device(args.device)
    particles = torch.tensor(PARTICLES, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def one(_):
        with handlers.Seed(gen):
            return calo_simulation(particles)

    hists = torch.func.vmap(one, randomness="different")(torch.empty(args.n, device=dev))
    mean = to_np(hists.mean(0))
    var = to_np(hists.var(0, unbiased=False))
    occupied = mean > 0
    print(f"simulations: {args.n}; voxels occupied: {occupied.sum()} / {mean.size}")
    print(f"total deposited energy: mean {mean.sum():.4f}")
    print(f"occupied-voxel mean energy: {mean[occupied].mean():.5f}")
    print(f"occupied-voxel variance:    {var[occupied].mean():.6f}")
    print(f"max voxel mean {mean.max():.5f}, max voxel var {var.max():.6f}")
    if args.out:
        np.savez(args.out, mean=mean, var=var)
        print(f"saved to {args.out}")
    return mean, var


if __name__ == "__main__":
    main()
