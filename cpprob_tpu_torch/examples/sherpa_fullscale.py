"""SHERPA at scale — CNN3D-guided CSIS on the FULL 35x35x20 calorimeter;
counterpart of ``examples/sherpa_fullscale.py``.

The reference drives the external SHERPA generator through an ABC observe
on a 35x35x20 voxel calorimeter with a CNN3D observation embedding
(``src/models/sherpa.cpp:29-86``, ``src/models/calorimeter.cpp``,
``infcomp/nn/observation.py:56-93``).  This driver runs the same structure
at full volume on one card: train a CNN3D-embedded CSIS proposal on the
synthetic tau-decay calorimeter model (``models/sherpa.py``), measure
traces/s, then run prior SIS and guided ``infer`` for each of the four
channels over five ABC tempers and four defensive weights.  The gate (full
mode): at one (temper, defensive) point all four channels are recovered
and the guided/prior ESS ratio is above 1 on every channel.

Prints the metric as one JSON line; ``--out`` writes the whole record.

    python -m cpprob_tpu_torch.examples.sherpa_fullscale [--steps 300] [--quick]
        [--device cuda] [--out sherpa_fullscale.json]
"""

import argparse
import json
import time

TOL_SCALES = [1.0, 3.0, 10.0, 30.0, 100.0]
DEFENSIVES = [None, 0.1, 0.3, 0.5]


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="sherpa_fullscale")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--max-deposits", type=int, default=4096)
    ap.add_argument("--bins", type=int, nargs=3, default=[35, 35, 20])
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="smoke mode: tiny volume + few steps")
    add_device_flag(ap)
    return ap


def _round(xs, nd):
    return [round(float(x), nd) for x in xs]


def run(args):
    """The whole experiment; returns ``(payload, engine, params,
    observed_for)`` so a caller can drive the trained engine further."""
    import numpy as np
    import torch

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.core import handlers
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models.sherpa import CHANNEL_MOMENTA, sherpa_calorimeter_wrapper
    from cpprob_tpu_torch.util.profiling import env_versions

    from ..util.device import resolve_device
    from ._common import sync, to_np

    if args.quick:
        args.bins, args.max_deposits = [7, 7, 5], 256
        args.steps, args.particles = 40, 64
    dev = resolve_device(args.device)
    bins = tuple(args.bins)
    vox = bins[0] * bins[1] * bins[2]

    # the temper is a model argument: one trained proposal serves every tau
    def model(observed, temper=1.0):
        return sherpa_calorimeter_wrapper(
            observed, n_bins=bins, max_deposits=args.max_deposits, abc_temper=temper)

    def observed_for(ch):
        tr = handlers.TraceHandler()
        gen = torch.Generator(device=dev).manual_seed(100 + ch)
        with handlers.Substitute({"channel_u": torch.tensor(ch + 0.5, device=dev)}), \
                handlers.Seed(gen), handlers.SimulateObserves(), tr:
            model(torch.zeros(vox, device=dev), 1.0)
        return tr.trace["calo"]["value"]

    def chpost(res):
        chs = to_np(res.predicts["Decay Channel"])
        w = to_np(res.normalized_weights)
        return np.array([(w * (chs == c)).sum() for c in range(4)])

    def mom_truth(ch):
        active = (np.arange(4) <= ch)[:, None]
        return (CHANNEL_MOMENTA[:, :3] * active).sum(axis=0)

    def momenta(res):
        return np.array([float(res.empirical(f"Momentum {a}").mean) for a in "XYZ"])

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} volume={bins} ({vox} voxels) max_deposits={args.max_deposits}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    eng = CSIS(model, (torch.zeros(vox, device=dev), 1.0), embedding_dim=64,
               obs_embedding="cnn3d", obs_shape=bins, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    params, losses = eng.compile(0, steps=args.steps, batch_size=args.batch_size,
                                 unroll=10, learning_rate=args.lr)
    losses = to_np(losses)  # the host copy closes the timed region
    train_s = time.perf_counter() - t0
    traces = args.steps * args.batch_size
    tps = traces / train_s
    print(f"trained {traces} traces in {train_s:.1f}s = {tps:.1f} traces/s")
    print(f"loss {losses[0]:.3f} -> {losses[-10:].mean():.3f}")

    rows, infer_s = [], []
    wins = 0
    for ch in range(4):
        obs = observed_for(ch)
        truth = mom_truth(ch)
        per_scale = []
        for s in TOL_SCALES:
            p = ct.sis(model, (obs, s), args.particles, 17 * ch + 2, device=dev)
            pp, mp = chpost(p), momenta(p)
            variants = {}
            for lam in DEFENSIVES:
                sync(dev)
                t1 = time.perf_counter()
                g = eng.infer(params, (obs, s), args.particles, 17 * ch + 1, defensive=lam)
                pg = chpost(g)  # the host copy closes the timed region
                infer_s.append(time.perf_counter() - t1)
                mg = momenta(g)
                variants[str(lam)] = {
                    "guided_posterior": _round(pg, 4),
                    "guided_ess": round(float(g.ess), 2),
                    "ess_ratio": round(float(g.ess) / max(float(p.ess), 1e-9), 2),
                    "guided_momentum_mean": _round(mg, 3),
                    "guided_momentum_abs_err": round(float(np.abs(mg - truth).sum()), 3),
                    "guided_channel_correct": bool(pg.argmax() == ch),
                }
            base = variants["None"]
            per_scale.append({
                "abc_temper": s,
                "prior_posterior": _round(pp, 4),
                "prior_ess": round(float(p.ess), 2),
                "prior_momentum_mean": _round(mp, 3),
                "true_momentum": _round(truth, 3),
                "prior_momentum_abs_err": round(float(np.abs(mp - truth).sum()), 3),
                **base,
                "defensive_variants": {k: v for k, v in variants.items() if k != "None"},
            })
            ratios = {k: v["ess_ratio"] for k, v in variants.items()}
            print(f"ch {ch} tau {s:>6}: guided {np.round(base['guided_posterior'], 3)} "
                  f"prior_ess {float(p.ess):.1f} ess_ratio by defensive {ratios}")
        wins += int(per_scale[0]["guided_channel_correct"])
        rows.append({"channel": ch, "by_tolerance": per_scale})

    def get(ch, si, lam, field):
        bt = rows[ch]["by_tolerance"][si]
        return bt["defensive_variants"][str(lam)][field] if lam is not None else bt[field]

    # the operating point: the (temper, defensive) with the best worst-case
    # channel ESS ratio, all four channels recovered first
    best, tradeoff = None, []
    for si, s in enumerate(TOL_SCALES):
        best_s = None
        for lam in DEFENSIVES:
            min_ratio = min(get(ch, si, lam, "ess_ratio") for ch in range(4))
            correct = all(get(ch, si, lam, "guided_channel_correct") for ch in range(4))
            err_by_ch = [get(ch, si, lam, "guided_momentum_abs_err") for ch in range(4)]
            cand = {"abc_temper": s, "defensive": lam,
                    "min_channel_ess_ratio": min_ratio,
                    "all_channels_correct": correct,
                    "guided_momentum_abs_err_by_channel": err_by_ch,
                    "max_channel_momentum_abs_err": max(err_by_ch)}
            if best is None or ((correct, min_ratio)
                                > (best["all_channels_correct"],
                                   best["min_channel_ess_ratio"])):
                best = cand
            if best_s is None or min_ratio > best_s["min_channel_ess_ratio"]:
                best_s = {
                    "abc_temper": s, "best_defensive": lam,
                    "min_channel_ess_ratio": min_ratio,
                    "max_channel_guided_momentum_abs_err": max(err_by_ch),
                    "max_channel_prior_momentum_abs_err": max(
                        rows[ch]["by_tolerance"][si]["prior_momentum_abs_err"]
                        for ch in range(4)),
                    "all_channels_correct": correct,
                }
        tradeoff.append(best_s)
    print(f"operating point: {best}")
    if not args.quick:
        # guided beats the prior's ESS on ALL FOUR channels at one point
        assert best["all_channels_correct"], best
        assert best["min_channel_ess_ratio"] > 1.0, best

    payload = {
        "experiment": "sherpa_fullscale_cnn3d_csis",
        "reference": "src/models/sherpa.cpp:29-86 + calorimeter.cpp + "
                     "infcomp/nn/observation.py:56-93",
        "device": name,
        "volume": list(bins),
        "max_deposits": args.max_deposits,
        "particles": args.particles,
        "train": {"steps": args.steps, "batch_size": args.batch_size,
                  "wall_s": train_s, "traces_per_sec": tps,
                  "loss_first": float(losses[0]),
                  "loss_last": float(losses[-10:].mean())},
        "infer_ms": {"median": 1e3 * float(np.median(infer_s)),
                     "min": 1e3 * float(np.min(infer_s)), "calls": len(infer_s)},
        "peak_memory_bytes": (int(torch.cuda.max_memory_allocated(dev))
                              if dev.type == "cuda" else None),
        "channel_recovery": rows,
        "operating_point": best,
        "accuracy_vs_temper_tradeoff": tradeoff,
        "untempered_point": tradeoff[0],
        "defensives_swept": [str(d) for d in DEFENSIVES],
        "abc_tempers": TOL_SCALES,
        "abc_note": "abc_temper divides the ABC log-kernel (power posterior): "
                    "template ranking and channel recovery are preserved at any "
                    "temperature while the log-weight spread shrinks; temper 1 is "
                    "the exact counting variance",
        "guided_channel_correct_count_at_temper1": wins,
        "gate_enforced": not args.quick,
        "versions": env_versions(),
    }
    return payload, eng, params, observed_for


def main(argv=None):
    args = build_parser().parse_args(argv)
    payload = run(args)[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print("wrote", args.out)
    tps = payload["train"]["traces_per_sec"]
    print(json.dumps({"metric": "sherpa_fullscale_traces_per_sec", "value": tps,
                      "unit": "traces/s", "device": payload["device"]}))
    return payload


if __name__ == "__main__":
    main()
