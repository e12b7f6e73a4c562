"""Generated-kernel and streaming-resample benchmarks — counterpart of
``examples/kernel_bench.py``, through the port's builders:

1. the user-defined asymmetric 5-state chain through
   ``make_fused_discrete_ssm`` + ``build_smc_run(chunk=8)`` (its init and
   chunk kernels, K9 and K8), the evidence beside the exact forward
   recursion;
2. the linear-Gaussian model with ESS-triggered resampling live: the
   physics as a user ``step_elem`` through ``attach_fused_scalar_kernels``
   (K10, CUDA rendered from the function) and the streaming epoch at the
   chunk boundaries (K14, K15, K16 scatter);
2a. the same model per step through ``make_fused_lg_ssm`` +
   ``build_smc_run(chunk=1)``: the start (``lg_init_kernel``), one launch
   of its kernel a step, carrying the resample flag (K6 with the step's
   resample control), and the streaming epoch every step, flagged or not;
2b. the guided linear-Gaussian model through
   ``attach_fused_guided_scalar_kernels`` (K12's tensor-core twin, its
   narrow layout, at ``[3,16,16,2]``), and under a ``[3,64,64,2]`` net
   (``train_ssm_proposal``'s default width) with each kernel: the twin's
   wide layout (``mxu=True``, counted under ``guided_tc.wide``) and K12 on
   the FMA pipe (``mxu=False``);
2c. the guided 5-state chain through
   ``attach_fused_guided_discrete_kernels`` (K9, then K13 and its tables
   kernel);
3. the resample epoch alone: the streaming kernels against the sorted
   fill in plain PyTorch.

The proposal nets train with the reference's settings from seeds 10 (LG)
and 6 (chain): at some seeds the trainer's initial net puts a proposal
scale at its floor and the loss stays huge.  Each path's launches are
counted over its timed sweeps.  Prints the record, with the reference's
keys, as one JSON line; ``--out`` also writes it.

    python -m cpprob_tpu_torch.examples.kernel_bench [--n 24] [--device cuda]
"""

import argparse
import json
import sys
import time

TRANS5 = [
    [0.50, 0.20, 0.10, 0.10, 0.10],
    [0.05, 0.60, 0.20, 0.10, 0.05],
    [0.10, 0.10, 0.40, 0.30, 0.10],
    [0.20, 0.05, 0.05, 0.50, 0.20],
    [0.10, 0.10, 0.10, 0.10, 0.60],
]
MEANS5 = [-2.0, -1.0, 0.0, 1.0, 2.0]
STDS5 = [0.5, 1.0, 0.7, 1.2, 0.9]
INIT5 = [0.3, 0.1, 0.2, 0.2, 0.2]
HALF_LOG_2PI = 0.9189385332046727
SWEEPS = 8          # sweeps a timed iteration
ITERS = 5           # timed iterations a path
TRAIN_FRACTION = 1.0  # of the reference's proposal training steps (600 LG, 300 chain)
LG_NET_SEED, CHAIN_NET_SEED = 10, 6
# the [3,64,64,2] net: train_ssm_proposal's defaults from this seed, whose
# initial net the benchmark's guided_lg net also starts from
LG_WIDE_NET_SEED = 1


def lg_step_elem(x, y, eps):
    """The linear-Gaussian physics as a user ``step_elem``."""
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - HALF_LOG_2PI


def build_parser():
    from ..util.device import add_device_flag

    ap = argparse.ArgumentParser(prog="kernel_bench")
    ap.add_argument("--n", type=int, default=24, help="log2 particles")
    ap.add_argument("--T", type=int, default=16)
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.inference.resampling import sorted_systematic_resample_values
    from cpprob_tpu_torch.inference.smc_csis import train_ssm_proposal
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        linear_gaussian_ssm,
        obs_logpdf_elem,
        trans_logpdf_elem,
    )
    from cpprob_tpu_torch.ops import stream_resample
    from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm
    from cpprob_tpu_torch.ops.fused_ssm import (
        attach_fused_guided_discrete_kernels,
        attach_fused_guided_scalar_kernels,
        attach_fused_scalar_kernels,
        discrete_hmm_log_evidence,
        make_fused_discrete_ssm,
    )
    from cpprob_tpu_torch.util.profiling import StageTimer, counters, env_versions

    from ..util.device import resolve_device
    from ._common import sync, to_np

    dev = resolve_device(args.device)
    N, T = 1 << args.n, args.T
    iters, train = ITERS, TRAIN_FRACTION
    st = StageTimer()
    out = {"artifact": "generated-kernel + streaming-resample benchmarks",
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "n_particles": N, "T": T}

    def timed_sweeps(run, obs, label, seed0):
        """One warm sweep, then ``iters`` timed iterations of SWEEPS sweeps;
        returns (median sweep s, logZs, resamples a sweep, the launch
        counters that moved over the timed iterations, ``"group.key": n``
        as ``counters()`` names them)."""
        run(seed0, obs)
        sync(dev)
        before = counters()
        per_iter, results = [], []
        for i in range(iters):
            with st.stage(f"{label}:timed_iters", sync=True):
                t0 = time.perf_counter()
                results += [run(seed0 + 1 + i * SWEEPS + s, obs) for s in range(SWEEPS)]
                sync(dev)
                per_iter.append((time.perf_counter() - t0) / SWEEPS)
        launches = {k: v - before.get(k, 0) for k, v in counters().items()
                    if v != before.get(k, 0) and not k.startswith("host_reads.")}
        lz = to_np(torch.stack([r.log_evidence for r in results]))
        epochs = to_np(torch.stack([r.resampled.sum() for r in results]))
        return float(np.median(per_iter)), lz, epochs, launches

    # --- 1. user-defined 5-state HMM through the spec builder
    rng = np.random.default_rng(0)
    z = rng.choice(5, p=INIT5)
    ys5 = []
    for _ in range(T):
        ys5.append(MEANS5[z] + STDS5[z] * rng.standard_normal())
        z = rng.choice(5, p=TRANS5[z])
    ys5 = np.array(ys5, np.float32)
    exact5 = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys5)
    obs5 = torch.as_tensor(ys5, device=dev)
    ssm5 = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5)
    dt5, lzs, _, launches = timed_sweeps(build_smc_run(ssm5, N, chunk=8), obs5, "hmm5", 0)
    out["discrete_5state_spec_kernel"] = {
        "particle_steps_per_s": N * T / dt5, "sweep_s": dt5,
        "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
        "sweeps": len(lzs), "exact_log_evidence": exact5, "chunk": 8,
        "launches": launches,
        "builder": "make_fused_discrete_ssm (ops/fused_ssm.py)",
    }
    print(f"5-state spec kernel: {N * T / dt5 / 1e9:.2f} G steps/s, logZ "
          f"{np.mean(lzs):.4f} vs exact {exact5:.4f}, launches {launches}", file=sys.stderr)

    # --- 2. linear-Gaussian with live resampling (streaming epoch)
    ys = torch.randn(T, generator=torch.Generator().manual_seed(7)) * 1.5
    kalman = float(kalman_filter_1d(to_np(ys))[2])
    ys = ys.to(dev)
    lg = attach_fused_scalar_kernels(linear_gaussian_ssm, lg_step_elem)
    dtlg, lzs, ep, launches = timed_sweeps(build_smc_run(lg, N, chunk=8), ys, "lg", 100)
    out["linear_gaussian_live_resampling"] = {
        "particle_steps_per_s": N * T / dtlg, "sweep_s": dtlg,
        "resample_epochs_mean": float(np.mean(ep)),
        "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
        "sweeps": len(lzs), "kalman_log_evidence": kalman, "sweeps_per_call": SWEEPS,
        "launches": launches,
        "epoch_resampler": "streaming stats + pass-1 scan + pass-2 scatter "
                           "(ops/stream_resample.py)",
    }
    print(f"LG live-resample: {N * T / dtlg / 1e9:.2f} G steps/s ({np.mean(ep)} epochs), "
          f"logZ {np.mean(lzs):.3f} vs kalman {kalman:.3f}, launches {launches}",
          file=sys.stderr)

    # --- 2a. linear-Gaussian per step: the flag carried by the one-step launch
    dts, lzs, ep, launches = timed_sweeps(build_smc_run(make_fused_lg_ssm(), N, chunk=1),
                                          ys, "lg_step", 200)
    # a sweep: the start (lg_init_kernel), T - 1 one-step launches, an epoch
    # a step and the close (K14); counted on the card (the plain versions
    # count none)
    if dev.type == "cuda":
        sw = iters * SWEEPS
        want = {"fused_lg.init": sw, "fused_lg.step_ctrl": sw * (T - 1),
                "stream_resample.lse_stats": sw * T}
        if {k: launches.get(k) for k in want} != want:
            raise AssertionError(f"LG per step: launches {launches}, expected {want}")
    out["linear_gaussian_per_step"] = {
        "particle_steps_per_s": N * T / dts, "sweep_s": dts,
        "resample_epochs_mean": float(np.mean(ep)),
        "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
        "sweeps": len(lzs), "kalman_log_evidence": kalman, "launches": launches,
        "builder": "make_fused_lg_ssm (ops/fused_lg.py), chunk=1",
    }
    print(f"LG per step: {N * T / dts / 1e9:.2f} G steps/s ({np.mean(ep)} epochs), "
          f"logZ {np.mean(lzs):.3f} vs kalman {kalman:.3f}, launches {launches}",
          file=sys.stderr)

    # --- 2b. guided linear-Gaussian through the guided chunk kernel
    with st.stage("train_lg", sync=True):
        gparams, _ = train_ssm_proposal(linear_gaussian_ssm, LG_NET_SEED, T, kind="normal",
                                        steps=max(int(600 * train), 1), batch_size=256,
                                        hidden=16, device=dev)
    dens = dict(trans_logpdf_elem=trans_logpdf_elem, obs_logpdf_elem=obs_logpdf_elem)
    lg_guided = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, gparams, T, **dens)
    dtg, lzs, ep, launches = timed_sweeps(build_smc_run(lg_guided, N, chunk=8), ys,
                                          "lg_guided", 400)
    # launches are counted on the card (the plain versions count none)
    n_launch = iters * SWEEPS * -(-(T - 1) // 8) if dev.type == "cuda" else None
    if launches.get("guided_tc.guided_tc") != n_launch or "guided_tc.wide" in launches:
        raise AssertionError(f"the [3,16,16,2] twin's launches {launches}: expected "
                             f"{n_launch} under guided_tc.guided_tc, none wide")
    out["linear_gaussian_guided_fused"] = {
        "particle_steps_per_s": N * T / dtg, "sweep_s": dtg,
        "resample_epochs_mean": float(np.mean(ep)),
        "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
        "sweeps": len(lzs), "kalman_log_evidence": kalman, "launches": launches,
        "proposal": "in-kernel MLP [3,16,16,2] (smc_csis 'normal' head), tensor cores",
        "builder": "attach_fused_guided_scalar_kernels (ops/fused_ssm.py)",
    }
    print(f"LG guided fused: {N * T / dtg / 1e9:.2f} G steps/s, logZ {np.mean(lzs):.3f} "
          f"vs kalman {kalman:.3f}, launches {launches}", file=sys.stderr)

    # the same model under a [3,64,64,2] net, the trainer's default width,
    # with each kernel: the twin's wide layout and K12 on the FMA pipe
    with st.stage("train_lg_wide", sync=True):
        wparams, _ = train_ssm_proposal(linear_gaussian_ssm, LG_WIDE_NET_SEED, T,
                                        kind="normal", steps=max(int(300 * train), 1),
                                        device=dev)
    for mxu, key, name in ((True, "guided_tc.wide", "linear_gaussian_guided_wide_tc"),
                           (False, "guided_scalar.guided", "linear_gaussian_guided_wide_fma")):
        model = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, wparams, T,
                                                   mxu=mxu, **dens)
        dtw, lzs, ep, launches = timed_sweeps(build_smc_run(model, N, chunk=8), ys,
                                              name, 600 + 100 * mxu)
        if launches.get(key) != n_launch or "guided_tc.guided_tc" in launches:
            raise AssertionError(f"{name}: launches {launches}, expected {n_launch} "
                                 f"under {key} and none under guided_tc.guided_tc")
        kernel = type(model.fused_chunk_t_batch.kernel).__name__
        out[name] = {
            "particle_steps_per_s": N * T / dtw, "sweep_s": dtw,
            "resample_epochs_mean": float(np.mean(ep)),
            "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
            "sweeps": len(lzs), "kalman_log_evidence": kalman, "launches": launches,
            "proposal": f"in-kernel MLP [3,64,64,2] (smc_csis 'normal' head), {kernel}",
            "builder": f"attach_fused_guided_scalar_kernels(mxu={mxu}) (ops/fused_ssm.py)",
        }
        print(f"LG guided [3,64,64,2] mxu={mxu} ({kernel}): {N * T / dtw / 1e9:.2f} G "
              f"steps/s, logZ {np.mean(lzs):.3f} vs kalman {kalman:.3f}, launches "
              f"{launches}", file=sys.stderr)

    # --- 2c. guided 5-state chain through the guided discrete kernels
    with st.stage("train_chain", sync=True):
        dparams, _ = train_ssm_proposal(ssm5, CHAIN_NET_SEED, T, kind="discrete",
                                        n_states=5, steps=max(int(300 * train), 1),
                                        batch_size=256, hidden=16, device=dev)
    g5 = attach_fused_guided_discrete_kernels(TRANS5, MEANS5, STDS5, INIT5,
                                              params=dparams, T=T)
    dtg5, lzs, _, launches = timed_sweeps(build_smc_run(g5, N, chunk=8), obs5,
                                          "hmm5_guided", 500)
    out["discrete_5state_guided_fused"] = {
        "particle_steps_per_s": N * T / dtg5, "sweep_s": dtg5,
        "log_evidence_mean": float(np.mean(lzs)), "log_evidence_std": float(np.std(lzs)),
        "sweeps": len(lzs), "exact_log_evidence": exact5, "launches": launches,
        "proposal": "in-kernel categorical head [K+2,16,16,K]",
        "builder": "attach_fused_guided_discrete_kernels (ops/fused_ssm.py)",
    }
    print(f"5-state guided fused: {N * T / dtg5 / 1e9:.2f} G steps/s, logZ "
          f"{np.mean(lzs):.4f} vs exact {exact5:.4f}, launches {launches}", file=sys.stderr)

    # --- 3. the resample epoch: streaming kernels vs the sorted fill
    g = torch.Generator(device=dev)
    log_w = torch.randn(N, generator=g.manual_seed(1), device=dev) * 2.0
    vals = torch.randn(N, generator=g.manual_seed(2), device=dev)

    def epochs(fn, label):
        fn(torch.Generator(device=dev).manual_seed(0))
        sync(dev)
        ts = []
        for i in range(max(iters - 1, 1)):
            with st.stage(label, sync=True):
                t0 = time.perf_counter()
                for s in range(SWEEPS):
                    fn(torch.Generator(device=dev).manual_seed(1 + i * SWEEPS + s))
                sync(dev)
                ts.append((time.perf_counter() - t0) / SWEEPS)
        return float(np.median(ts))

    t_stream = epochs(lambda gen: stream_resample.streaming_systematic_resample_values(
        gen, log_w, vals), "epoch_stream")
    t_sorted = epochs(lambda gen: sorted_systematic_resample_values(gen, log_w, vals),
                      "epoch_sorted")
    out["resample_epoch"] = {"streaming_pallas_s": t_stream, "xla_sorted_fill_s": t_sorted,
                             "speedup": t_sorted / t_stream,
                             "note": "streaming_pallas_s: the port's streaming CUDA "
                                     "kernels; xla_sorted_fill_s: the sorted fill in "
                                     "plain PyTorch (the reference's key names)"}
    print(f"epoch at 2^{args.n}: streaming {t_stream * 1e3:.3f} ms vs sorted-fill "
          f"{t_sorted * 1e3:.3f} ms = {t_sorted / t_stream:.1f}x", file=sys.stderr)

    out["stages"] = st.as_dict()
    out["versions"] = env_versions()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
