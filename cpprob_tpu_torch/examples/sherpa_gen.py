"""Channel-conditioned dry-run event dumper — counterpart of
``examples/sherpa_gen.py`` (reference ``src/models/sherpa_gen.cpp:10-51`` and
``sherpa_mini_gen.cpp``): generate events from the synthetic SHERPA toy,
optionally conditioned on a decay channel, and dump the histograms for
offline inspection or network pre-training.  Every event draws from one
generator on the device, seeded with ``--seed``.

    python -m cpprob_tpu_torch.examples.sherpa_gen --channel 2 -n 16 --out events
"""

import argparse
import os


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="sherpa_gen")
    ap.add_argument("--channel", type=int, default=None,
                    help="condition on this decay channel (0-3); default prior")
    ap.add_argument("-n", type=int, default=8)
    ap.add_argument("--out", default="sherpa_events")
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cpprob_tpu_torch.core import handlers
    from cpprob_tpu_torch.models.sherpa import sherpa_mini

    from ..util.device import resolve_device
    from ._common import to_np

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    substitutions = {}
    if args.channel is not None:
        # channel = floor(channel_u): condition the latent uniform
        substitutions["channel_u"] = torch.tensor(args.channel + 0.5, device=dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    paths = []
    for i in range(args.n):
        pc = handlers.PredictCollector()
        with handlers.Substitute(substitutions), handlers.Seed(gen), pc:
            img = sherpa_mini()
        ch = int(pc.predicts["Channel"][0])
        path = os.path.join(args.out, f"event_{i:04d}_ch{ch}.npy")
        np.save(path, to_np(img).reshape(100, 100))
        paths.append(path)
        print(f"dumped {path} (channel {ch}, total E {float(img.sum()):.3f})")
    return paths


if __name__ == "__main__":
    main()
