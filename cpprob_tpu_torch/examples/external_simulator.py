"""External black-box simulator demo — counterpart of
``examples/external_simulator.py``: compile -> guided inference against an
out-of-process event generator (the reference's SHERPA workflow shape,
``src/models/sherpa.cpp:29-86``: sample decay channel + kinematics, run an
external generator, ABC-observe the calorimeter response, predict channel).

Run with no arguments, it spawns ITSELF with ``--simulator`` as the
external generator child (a numpy-only toy calorimeter in its own process,
this module's own copy of the reference's child), then

1. trains a static-structure CSIS proposal whose prior traces run THROUGH
   the child from inside the vmapped trace batch (``observe_external``),
   and a ``DynamicCSIS`` eager proposal (per-trace execution);
2. runs three inference legs on a held-out event: prior SIS (vmapped),
   guided CSIS (vmapped, the child in the loop: one pipelined exchange a
   site for the population) and guided CSIS per particle (eager), each
   timed;
3. gates (full mode, ``--traces`` >= 2000): channel recovery on every leg,
   mean guided/prior ESS ratio > 1 over seeds, and the guided energy
   posterior within 5 of a large prior-SIS estimate and within 15 of the
   truth.

Prints one JSON record as the last line (with the exchanges and host reads
of one guided call); ``--out`` also writes it to a file.

    python -m cpprob_tpu_torch.examples.external_simulator [--traces 4000]
        [--particles 2048] [--device cuda]
"""

import argparse
import json
import math
import os
import sys
import time

# ---------------------------------------------------------------------------
# Child process: the "external" generator.  numpy only; the parent treats
# it as an opaque executable.
# ---------------------------------------------------------------------------

GRID = 8
OBS_DIM = GRID * GRID
N_CHANNELS = 3


def simulator_main():
    import numpy as np

    # EXTSIM_SEED makes the child reproducible (gate stability); default is
    # per-process randomness, as a real external generator would have
    seed = os.environ.get("EXTSIM_SEED")
    rng = np.random.default_rng(int(seed) if seed else os.getpid())
    # channel-specific shower shapes: blob center (row, col) and width
    centers = [(2.0, 2.0), (5.0, 5.0), (2.0, 5.0)]
    widths = [0.9, 1.4, 0.7]
    yy, xx = np.mgrid[0:GRID, 0:GRID]

    sys.stdout.write(f"ready {OBS_DIM}\n")
    sys.stdout.flush()
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        ch = int(float(parts[0]))
        energy = float(parts[1])
        cy, cx = centers[ch % N_CHANNELS]
        w = widths[ch % N_CHANNELS]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * w * w))
        mean = energy * blob / blob.sum()
        deposits = rng.poisson(mean).astype(np.float32)
        sys.stdout.write(" ".join(str(v) for v in deposits.ravel()) + "\n")
        sys.stdout.flush()


def child_argv():
    """The command that starts this module's simulator child; the package's
    directory goes on the child's ``PYTHONPATH``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    paths = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    os.environ["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return [sys.executable, "-m", "cpprob_tpu_torch.examples.external_simulator",
            "--simulator"]


# ---------------------------------------------------------------------------
# Parent: probabilistic program wrapping the child
# ---------------------------------------------------------------------------


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="external_simulator")
    ap.add_argument("--traces", type=int, default=4000)
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--seeds", type=int, default=8,
                    help="independent inference repeats for the ESS-ratio "
                         "and energy-error gates")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    return ap


def make_models(sim):
    """(eager model, vmapped model) over ``sim``, as in the reference."""
    import numpy as np
    import torch

    from cpprob_tpu_torch.core import observe, predict, sample
    from cpprob_tpu_torch.distributions import Uniform, UniformInt, make_abc
    from cpprob_tpu_torch.external import observe_external

    def abc_logpdf(simulated):
        """Poisson-ish per-voxel ABC tolerance (sherpa.cpp:61 uses
        Var = value; here Var = max(simulated, 1))."""
        def logpdf(observed):
            var = torch.clamp(simulated, min=1.0)
            d = observed - simulated
            return torch.sum(-0.5 * d * d / var - 0.5 * torch.log(2 * math.pi * var))
        return logpdf

    def model_eager(observed):
        """Calls the external process directly: one live trace, one
        generator call (the reference's execution model)."""
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = torch.as_tensor(sim(np.array([float(ch), float(energy)])),
                                   device=energy.device)
        observe(make_abc(lambda g: deposits, abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    def model_traced(observed):
        """The same program with the simulator behind ``observe_external``:
        under vmap the whole population goes to the child in one exchange."""
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(sim, torch.stack([ch.float(), energy]), OBS_DIM)
        observe(make_abc(lambda g: deposits, abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    return model_eager, model_traced


def main(argv=None):
    args = build_parser().parse_args(argv)
    full_mode = args.traces >= 2000  # gates need statistical resolution

    import numpy as np
    import torch

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.distributions.base import HOST_READS
    from cpprob_tpu_torch.external import SubprocessSimulator
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.inference.csis_dynamic import DynamicCSIS

    from ..util.device import resolve_device
    from ._common import sync, to_np

    dev = resolve_device(args.device)
    os.environ.setdefault("EXTSIM_SEED", "7")  # reproducible gates
    sim = SubprocessSimulator(child_argv(), OBS_DIM)
    try:
        model_eager, model_traced = make_models(sim)

        # ground-truth event from the child itself
        true_ch, true_e = 1, 37.0
        observed = torch.as_tensor(sim(np.array([true_ch, true_e])), device=dev)
        n = args.particles

        # compile A: static CSIS; every trace batch runs through the child
        eng_t = CSIS(model_traced, (torch.zeros(OBS_DIM),), device=dev)
        steps = max(30, args.traces // 64)
        t0 = time.time()
        params_t, losses_t = eng_t.compile(0, steps=steps, batch_size=64)
        losses_t = to_np(losses_t)
        compile_traced_s = time.time() - t0
        print(f"compile traced: {steps * 64} external traces in {compile_traced_s:.1f}s, "
              f"loss {losses_t[0]:.2f} -> {losses_t[-10:].mean():.2f}", file=sys.stderr)

        # compile B: DynamicCSIS eager (the reference's per-trace loop)
        n_eager = max(200, args.traces // 4)
        eng_e = DynamicCSIS(model_eager, (torch.zeros(OBS_DIM),), probe=16, device=dev)
        params_e, stats = eng_e.compile(0, n_traces=n_eager)
        print(f"compile eager: {n_eager} external traces, loss {stats['losses'][0]:.2f} "
              f"-> {stats['losses'][-1]:.2f}", file=sys.stderr)

        def channel_posterior(res):
            w = to_np(res.normalized_weights)
            chs = to_np(res.predicts["Channel"])
            return np.array([(w * (chs == c)).sum() for c in range(N_CHANNELS)])

        def energy_mean(res):
            return float((to_np(res.normalized_weights) * to_np(res.predicts["Energy"])).sum())

        def ess(res):
            w = to_np(res.normalized_weights).astype(np.float64)
            return float(1.0 / np.sum(w * w))

        # legs over independent seeds: prior (vmapped) vs guided (vmapped)
        ess_p, ess_g, em_p, em_g, post_p, post_g, t_guided = [], [], [], [], [], [], []
        per_call = None
        for s in range(args.seeds):
            ex0, hr0 = sim.n_exchanges, HOST_READS["observe_external"]
            t0 = time.time()
            rg = eng_t.infer(params_t, (observed,), n, 10 + s)
            post_g.append(channel_posterior(rg))  # the host copy closes the timed region
            t_guided.append(time.time() - t0)
            if per_call is None:
                per_call = {"exchanges": sim.n_exchanges - ex0,
                            "host_reads": HOST_READS["observe_external"] - hr0}
            rp = ct.sis(model_traced, (observed,), n, 100 + s, device=dev)
            ess_g.append(ess(rg))
            ess_p.append(ess(rp))
            em_g.append(energy_mean(rg))
            em_p.append(energy_mean(rp))
            post_p.append(channel_posterior(rp))
        # the first call warms the path; later calls measure it
        warm = t_guided[1:] if len(t_guided) > 1 else t_guided
        traced_pps = n / float(np.median(warm))

        # eager guided leg (per-particle child calls) for the comparison
        n_eager_particles = max(32, n // 16)
        sync(dev)
        t0 = time.time()
        res_eager = eng_e.infer(params_e, (observed,), n_eager_particles, 2)
        post_eager = channel_posterior(res_eager)
        eager_pps = n_eager_particles / (time.time() - t0)

        # a large prior-SIS estimate of the same energy posterior
        ref_ems = []
        if full_mode:
            for s in range(4):
                ref_ems.append(energy_mean(ct.sis(model_traced, (observed,), 16384,
                                                  1000 + s, device=dev)))
        ref_mean = float(np.mean(ref_ems)) if ref_ems else None

        ratio = float(np.mean(ess_g) / np.mean(ess_p))
        err_g = float(np.mean(np.abs(np.asarray(em_g) - true_e)))
        err_p = float(np.mean(np.abs(np.asarray(em_p) - true_e)))
        err_g_ref = float(abs(np.mean(em_g) - ref_mean)) if ref_mean is not None else None
        print(f"true channel {true_ch}; guided posterior {post_g[0]}, prior {post_p[0]}, "
              f"eager guided {post_eager}", file=sys.stderr)
        print(f"mean ESS over {args.seeds} seeds: guided {np.mean(ess_g):.1f} prior "
              f"{np.mean(ess_p):.1f} (ratio {ratio:.2f}) / {n}", file=sys.stderr)
        print(f"throughput: vmapped guided {traced_pps:.0f} particles/s vs eager guided "
              f"{eager_pps:.0f} particles/s", file=sys.stderr)

        for name, post in (("guided_vmapped", post_g[0]), ("prior", post_p[0]),
                           ("eager", post_eager)):
            assert int(post.argmax()) == true_ch, (name, post)
        if full_mode:
            assert ratio > 1.0, f"guided/prior ESS ratio {ratio:.2f} <= 1"
            assert err_g_ref < 5.0, (
                f"guided energy {np.mean(em_g):.2f} vs reference posterior {ref_mean:.2f}")
            assert err_g < 15.0, f"guided energy error {err_g:.2f} vs truth"

        out = {
            "experiment": "external_subprocess_simulator_bridge",
            "reference": "src/models/sherpa.cpp:29-86 (external generator + ABC "
                         "observe + channel/momentum predicts)",
            "simulator": "subprocess (numpy toy calorimeter, line protocol)",
            "device": str(dev),
            "n_compile_traces_traced": steps * 64,
            "n_compile_traces_eager": n_eager,
            "compile_traced_s": compile_traced_s,
            "n_particles": n,
            "n_seeds": args.seeds,
            "true_channel": true_ch,
            "true_energy": true_e,
            "prior_channel_posterior": post_p[0].tolist(),
            "guided_channel_posterior": post_g[0].tolist(),
            "eager_guided_channel_posterior": post_eager.tolist(),
            "mean_ess_prior": float(np.mean(ess_p)),
            "mean_ess_guided": float(np.mean(ess_g)),
            "ess_ratio_guided_over_prior": ratio,
            "reference_posterior_energy_mean": ref_mean,
            "reference_posterior_energy_seeds": [round(e, 2) for e in ref_ems],
            "energy_abs_err_guided_vs_reference_posterior": err_g_ref,
            "energy_abs_err_guided_vs_truth": err_g,
            "energy_abs_err_prior_vs_truth": err_p,
            "guided_energy_means": [round(e, 2) for e in em_g],
            "guided_call": {**per_call, "ms_median": 1e3 * float(np.median(warm))},
            "throughput_particles_per_s": {
                "guided_vmapped": traced_pps,
                "guided_eager_per_particle": eager_pps,
                "speedup": traced_pps / eager_pps,
            },
            "gates_enforced": bool(full_mode),
            "seams": {
                "compile_traced": "CSIS trace batches under vmap through "
                                  "observe_external (one exchange a step)",
                "compile_eager": "DynamicCSIS eager (host-side trace loop)",
                "prior_sis": "sis under vmap through observe_external",
                "guided_traced": "CSIS.infer under vmap through observe_external",
                "guided_eager": "DynamicCSIS.infer, per-particle messenger",
                "device": str(dev),
            },
        }
    finally:
        sim.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    if "--simulator" in sys.argv:
        simulator_main()
    else:
        main()
