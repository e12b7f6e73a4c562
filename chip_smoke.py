#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cpprob_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fenced with ``torch.cuda.synchronize()``; any failure raises
and the script exits non-zero without printing its last line:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of the CUDA kernels from ``cpprob_tpu_torch/ops/csrc`` (first use);
3. kernel vs plain PyTorch version on the card, same Philox seed, at the
   main path's shapes (2^26 particles, a 16-slot chunk): the init kernel,
   and the chunk kernel with the flag off and on, n_valid 15 and 8 of 16,
   and the island check off, forced (thresh 2.0), at the main path's 0.5,
   never firing (0.0) and at a threshold that splits the islands;
4. a multi-chunk sweep (chunk 4) whose boundary resamples go through the
   flag and ticks;
5. the main path: ``build_smc_run(make_fused_hmm_ssm(island_every=8),
   2^26, chunk=16)`` on the headline benchmark's observations (T = 16) for
   16 sweeps, checked against the exact forward-recursion evidence, with
   the kernels' launch counts and the interior island resamples of those
   sweeps;
6. informational timings at 2^26 (kernel vs plain, sweep time,
   particle-steps/s) and a ``torch.profiler`` trace of 8 back-to-back
   sweeps, written to ``chiprun_out/sweep_trace.json`` and summarised
   (device time by kernel, busy share of the span); then one JSON line on
   the kernels, the card line, and the result line
   ``{"ok": true, "device": {...}}``.

It needs a CUDA device and never falls back to the CPU.
"""

import json
import math
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

T = 16
CHUNK = 16
ISLAND_EVERY = 8
MAIN_N = 1 << 26
CHECK_N = 1 << 20         # the multi-chunk sweep
CHECK_SEED = 20261016
SWEEPS = 16
EXACT_LOGZ = -26.44222     # forward recursion on these observations


def _sync():
    torch.cuda.synchronize()


def _time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _spec():
    import numpy as np

    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.models import HMM_MEANS, HMM_TRANS

    return spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))


def _observations(device):
    from cpprob_tpu_torch.models import simulate_observations

    return torch.as_tensor(simulate_observations(T, 0), device=device)


def _close_stats(rec_k, rec_p, n, what):
    from cpprob_tpu_torch.ops.fused_hmm import stats_from_partials

    ess_k, cat_k, lme_k = stats_from_partials(rec_k, n)
    ess_p, cat_p, lme_p = stats_from_partials(rec_p, n)
    torch.testing.assert_close(ess_k, ess_p, rtol=1e-4, atol=0, msg=f"{what}: ess")
    torch.testing.assert_close(lme_k, lme_p, rtol=1e-4, atol=0, msg=f"{what}: lme")
    torch.testing.assert_close(cat_k, cat_p, rtol=0, atol=1e-4, msg=f"{what}: cat_w")


def _main_chunk(obs):
    """The main path's chunk of observations: 16 slots, 15 valid."""
    from cpprob_tpu_torch.inference.smc import _chunk_observations

    ys, valid = _chunk_observations(obs, CHUNK)
    return ys[0].contiguous(), valid[0]


def _split_thresh(seed, s0, w0, ys, ctrl):
    """A threshold that splits the islands at the t = 7 check: the middle of
    the widest gap between consecutive island ESS ratios in the middle half,
    from the plain version.  Returns (thresh, half-gap / thresh)."""
    from cpprob_tpu_torch.ops.fused_hmm import ISLAND_SIZE, hmm_chunk_plain

    ctrl8 = ctrl.clone()
    ctrl8[-1] = ISLAND_EVERY
    _, _, rec = hmm_chunk_plain(seed, s0, w0, ys[:ISLAND_EVERY].contiguous(),
                                ctrl8, _spec(), t0=1)
    r = rec.double()
    ratio = torch.sort(r[:, 1] ** 2 / (ISLAND_SIZE * r[:, 2])).values
    lo, hi = ratio.shape[0] // 4, 3 * ratio.shape[0] // 4
    gaps = ratio[lo + 1:hi + 1] - ratio[lo:hi]
    i = int(torch.argmax(gaps))
    thresh = float(ratio[lo + i] + ratio[lo + i + 1]) / 2
    return thresh, float(gaps[i]) / 2 / thresh


def check_kernels(n=MAIN_N, seed=CHECK_SEED):
    """Each kernel against its plain version on the card, same seed, at the
    main path's shapes (the chunk runs on the init kernel's population).
    Returns the largest |log_w| difference of each kernel (on the particles
    that must agree).  Raises on any disagreement."""
    from cpprob_tpu_torch.ops.fused_hmm import (
        ISLAND_SIZE,
        hmm_chunk,
        hmm_chunk_plain,
        hmm_init,
        hmm_init_plain,
    )

    dev = torch.device("cuda")
    spec = _spec()
    K = spec.K
    obs = _observations(dev)
    s_k, w_k, rec_k = hmm_init(seed, obs[0], n, spec)
    s_p, w_p, rec_p = hmm_init_plain(seed, obs[0], n, spec)
    _sync()
    if not torch.equal(s_k, s_p):
        raise AssertionError("init: states differ")
    torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=0, msg="init: log_w")
    _close_stats(rec_k, rec_p, n, "init")
    errs = {"init": float((w_k - w_p).abs().max())}
    print(f"check init n={n}: states equal, max|dlog_w|={errs['init']:.3g}")
    del s_p, w_p

    ys, n_valid = _main_chunk(obs)
    errs["chunk"] = 0.0
    n_isl = n // ISLAND_SIZE
    cases = []
    for flag in (0, 1):
        ctrl = torch.tensor([flag, n // 3, 2 * n // 3, int(n_valid)],
                            dtype=torch.int32, device=dev)
        split, margin = _split_thresh(seed, s_k, w_k, ys, ctrl)
        print(f"flag={flag}: split threshold {split:.6f}, half-gap "
              f"{margin:.3g} of it")
        cases += [(ctrl, 0, 0.5, None), (ctrl, ISLAND_EVERY, 2.0, 1.0),
                  (ctrl, ISLAND_EVERY, 0.5, None), (ctrl, ISLAND_EVERY, 0.0, 0.0),
                  (ctrl, ISLAND_EVERY, split, "split")]
    # n_valid 8: the t = 7 check sees t + 1 = n_valid and must not fire
    ctrl = torch.tensor([0, n // 3, 2 * n // 3, ISLAND_EVERY],
                        dtype=torch.int32, device=dev)
    cases.append((ctrl, ISLAND_EVERY, 2.0, 0.0))

    for ctrl, island_every, thresh, want in cases:
        kw = dict(t0=1, island_every=island_every, island_thresh=thresh)
        ok, ow, orec = hmm_chunk(seed, s_k, w_k, ys, ctrl, spec, **kw)
        pk, pw, prec = hmm_chunk_plain(seed, s_k, w_k, ys, ctrl, spec, **kw)
        _sync()
        what = (f"chunk n={n} flag={int(ctrl[0])} n_valid={int(ctrl[-1])}/"
                f"{ys.shape[0]} island_every={island_every} thresh={thresh:.6g}")
        counts = orec[:, -1]
        if not torch.equal(counts, prec[:, -1]):
            raise AssertionError(f"{what}: interior resample counts differ")
        fired = float(counts.mean())
        if want == "split":
            if not 0.0 < fired < 1.0:
                raise AssertionError(f"{what}: the islands did not split")
        elif want is not None and fired != want:
            raise AssertionError(f"{what}: {fired} resamples per island, "
                                 f"expected {want}")
        # a fired check may place up to K-1 slots differently (its ticks
        # come from sums taken in another order); nothing else may differ
        close = torch.isclose(ow, pw, rtol=1e-5, atol=0)
        bad = (ok != pk) | ~close
        per_isl = bad.view(n_isl, ISLAND_SIZE).sum(1)
        if bool((per_isl > (K - 1) * counts).any()):
            raise AssertionError(f"{what}: {int(bad.sum())} particles differ")
        _close_stats(orec, prec, n, what)
        err = float((ow - pw).abs()[~bad].max())
        errs["chunk"] = max(errs["chunk"], err)
        print(f"check {what}: {int(bad.sum())} slots differ, "
              f"mean resamples/island={fired:.4f}, max|dlog_w|={err:.3g}")
        del ok, ow, pk, pw, close, bad
    return errs


def check_multichunk(n=CHECK_N, chunk=4, seeds=8):
    """A sweep of several launches (chunk 4: valid 4, 4, 4, 3) whose
    boundary resamples go through the flag and ticks: logZ against the
    exact value, and at least one boundary resample."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models import hmm_log_evidence, simulate_observations
    from cpprob_tpu_torch.ops.fused_hmm import make_fused_hmm_ssm

    obs = _observations(torch.device("cuda"))
    run = build_smc_run(make_fused_hmm_ssm(island_every=ISLAND_EVERY,
                                           spec=_spec()), n, chunk=chunk)
    res = [run(500 + i, obs) for i in range(seeds)]
    zs = torch.stack([r.log_evidence for r in res]).cpu().numpy()
    resampled = int(torch.stack([r.resampled for r in res]).sum())
    exact = hmm_log_evidence(simulate_observations(T, 0))
    mean, se = float(zs.mean()), float(zs.std(ddof=1) / math.sqrt(seeds))
    print(f"check multi-chunk n={n} chunk={chunk}: mean logZ={mean:.6f} "
          f"SE={se:.3g} exact={exact:.6f}, boundary resamples={resampled}")
    if not abs(mean - exact) < 4 * se + 0.02:
        raise AssertionError("multi-chunk logZ outside 4 SE + 0.02 of exact")
    if resampled == 0:
        raise AssertionError("no chunk-boundary resample in the multi-chunk sweep")


def profile_sweeps(run, obs, card, sweeps=8):
    """torch.profiler over ``sweeps`` back-to-back sweeps of ``run``: the
    trace goes to chiprun_out/sweep_trace.json; prints the device time by
    kernel and the device's busy share of the traced span."""
    from torch.profiler import ProfilerActivity, profile

    run(30_000, obs)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(sweeps):
            run(30_001 + i, obs)
        _sync()
    out = os.path.join(REPO, "chiprun_out", "sweep_trace.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, reach = 0.0, spans[0][0]
    for a, b in spans:
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    span = reach - spans[0][0]
    by_name = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + float(e["dur"]))
    total = sum(us for _, us in by_name.values())
    print(f"[{card}] profile of {sweeps} back-to-back sweeps: span "
          f"{span / 1e3 / sweeps:.4f} ms per sweep, device busy share "
          f"{busy / span:.4f}, {len(dev) / sweeps:.1f} device operations per "
          f"sweep; trace in {os.path.relpath(out, REPO)}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / total:7.2%}  {us / 1e3 / sweeps:8.4f} ms/sweep  "
              f"{n / sweeps:5.1f}/sweep  {name[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    import numpy as np

    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models import hmm_log_evidence, simulate_observations
    from cpprob_tpu_torch.ops import _build, fused_hmm
    from cpprob_tpu_torch.util.profiling import (
        StageTimer,
        env_versions,
        gpu_name_and_power,
    )

    card = gpu_name_and_power()
    print(card)
    print("versions:", json.dumps(env_versions()))
    dev = torch.device("cuda")
    spec = _spec()
    stages = StageTimer()

    with stages.stage("build", sync=True):
        fused_hmm._lib()
    print(f"build: {stages.totals['build']:.2f} s")
    for line in _build.BUILD_LOGS.get("fused_hmm", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    with stages.stage("kernel_vs_plain", sync=True):
        errs = check_kernels()
    with stages.stage("multi_chunk", sync=True):
        check_multichunk()

    exact = hmm_log_evidence(simulate_observations(T, 0))
    if abs(exact - EXACT_LOGZ) > 1e-4:
        raise AssertionError(f"oracle {exact} != {EXACT_LOGZ}")
    obs = _observations(dev)
    island_counts = []
    model = fused_hmm.make_fused_hmm_ssm(island_every=ISLAND_EVERY, spec=spec,
                                         island_counts=island_counts)
    run = build_smc_run(model, MAIN_N, ess_threshold=0.5,
                        resampling="systematic", store_history=False,
                        chunk=CHUNK)
    run(10_000, obs)
    _sync()
    for name in fused_hmm.LAUNCHES:
        fused_hmm.LAUNCHES[name] = 0
    island_counts.clear()
    times, log_zs = [], []
    for i in range(SWEEPS):
        t0 = time.perf_counter()
        # a sweep never waits on the host: any synchronising call raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = run(i, obs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        times.append(time.perf_counter() - t0)
        log_zs.append(res.log_evidence)
    launches = dict(fused_hmm.LAUNCHES)
    sweep_counts = torch.stack(island_counts)
    zs = torch.stack(log_zs).cpu().numpy()
    if not np.isfinite(zs).all():
        raise AssertionError(f"non-finite logZ: {zs}")
    mean, se = float(zs.mean()), float(zs.std(ddof=1) / math.sqrt(SWEEPS))
    tol = 4 * se + 0.02
    print(f"main path n={MAIN_N} T={T} chunk={CHUNK} island_every={ISLAND_EVERY} "
          f"island_size={fused_hmm.ISLAND_SIZE}: mean logZ={mean:.6f} "
          f"SE={se:.3g} exact={exact:.6f} tol={tol:.4f}")
    if abs(mean - exact) > tol:
        raise AssertionError("main path logZ outside 4 SE + 0.02 of exact")
    n_chunks = -(-(T - 1) // CHUNK)
    if launches != {"init": SWEEPS, "chunk": SWEEPS * n_chunks}:
        raise AssertionError(f"launch counts {launches}")
    print(f"launches over {SWEEPS} sweeps: {launches}")
    if sweep_counts.shape != (SWEEPS * n_chunks, MAIN_N // fused_hmm.ISLAND_SIZE):
        raise AssertionError(f"island counts of shape {tuple(sweep_counts.shape)}")
    resamples = float(sweep_counts.mean())
    print(f"interior resamples per island per sweep, over the {SWEEPS} "
          f"main-path sweeps (mean): {resamples:.4f}")
    if not resamples > 0:
        raise AssertionError("the interior island trigger never fired")

    sweep_s = statistics.median(times)
    print(f"[{card}] median sweep {sweep_s * 1e3:.3f} ms, "
          f"{MAIN_N * T / sweep_s:.6g} particle-steps/s "
          f"(n={MAIN_N}, T={T}, {SWEEPS} sweeps, host clock, synced per sweep)")
    b2b_ms = _time_ms(lambda: run(20_000, obs), SWEEPS)
    print(f"[{card}] back-to-back sweeps: {b2b_ms:.4f} ms each by CUDA events, "
          f"{MAIN_N * T / (b2b_ms * 1e-3):.6g} particle-steps/s")

    # -- kernel vs plain time, on the main path's shapes and the inputs of
    # the kernel check's main-path case (flag off, n_valid 15, thresh 0.5) --
    seed = CHECK_SEED
    s0, w0, _ = fused_hmm.hmm_init(seed, obs[0], MAIN_N, spec)
    ys, n_valid = _main_chunk(obs)
    ctrl = torch.tensor([0, MAIN_N // 3, 2 * MAIN_N // 3, int(n_valid)],
                        dtype=torch.int32, device=dev)
    kw = dict(t0=1, island_every=ISLAND_EVERY, island_thresh=0.5)
    timing = {
        "init": (
            _time_ms(lambda: fused_hmm.hmm_init(seed, obs[0], MAIN_N, spec), 10),
            _time_ms(lambda: fused_hmm.hmm_init_plain(seed, obs[0], MAIN_N, spec), 2),
        ),
        "chunk": (
            _time_ms(lambda: fused_hmm.hmm_chunk(seed, s0, w0, ys, ctrl, spec, **kw), 10),
            _time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, s0, w0, ys, ctrl, spec, **kw), 2),
        ),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name} at n={MAIN_N}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    no_island_ms = _time_ms(lambda: fused_hmm.hmm_chunk(
        seed, s0, w0, ys, ctrl, spec, t0=1, island_every=0), 10)
    print(f"[{card}] chunk at n={MAIN_N}, island_every=0: kernel "
          f"{no_island_ms:.4f} ms")
    with stages.stage("profile", sync=True):
        profile_sweeps(run, obs, card)
    print(stages.report())

    src = "cpprob_tpu_torch/ops/csrc/fused_hmm.cu"
    kernels = [
        {"name": "hmm_init_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:727",
         "launches": launches["init"], "max_abs_err": errs["init"],
         "ms": timing["init"][0], "plain_ms": timing["init"][1]},
        {"name": "hmm_chunk_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:245",
         "launches": launches["chunk"], "max_abs_err": errs["chunk"],
         "ms": timing["chunk"][0], "plain_ms": timing["chunk"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
