#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cpprob_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fenced with ``torch.cuda.synchronize()``; any failure raises
and the script exits non-zero without printing its last line:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of the CUDA kernels from ``cpprob_tpu_torch/ops/csrc`` (first
   use; one nvcc per source, all started together), with the ptxas
   register and spill lines;
3. the HMM main path (``hmm_phases``): kernel vs plain PyTorch version on
   the card, same Philox seed, at the main path's shapes (2^26 particles, a
   16-slot chunk): the init kernel, and the chunk kernel with the flag off
   and on, n_valid 15 and 8 of 16, and the island check off, forced
   (thresh 2.0), at the main path's 0.5, never firing (0.0) and at a
   threshold that splits the islands; a multi-chunk sweep (chunk 4) whose
   boundary resamples go through the flag and ticks;
   ``build_smc_run(make_fused_hmm_ssm(island_every=8), 2^26, chunk=16)`` on
   the headline benchmark's observations (T = 16) for 16 sweeps, checked
   against the exact forward-recursion evidence, with the kernels' launch
   counts and the interior island resamples of those sweeps; timings
   (kernel vs plain, sweep time, particle-steps/s) and a
   ``torch.profiler`` trace of 8 back-to-back sweeps
   (``chiprun_out/sweep_trace.json``: device time by kernel, busy share);
4. the continuous-state path (``lg_phases``): at 2^24 particles, the LG
   chunk kernel against its plain version (t0 odd, even and 9, n_valid 8
   and 7), the one-step launch (and eight of them against one eight-step
   launch, bit for bit), the epoch's stats, pass-1 and pass-2 kernels
   (pass 2 against the exact expansion of its own start slots, the flag off
   and one heavy particle); ``build_smc_run(make_fused_lg_ssm(), 2^24,
   chunk=8)`` on T = 16 observations of the model for 16 sweeps, and the
   per-step path (chunk = 1) at 2^20 for 8 sweeps, each checked against
   the Kalman filter's evidence, with a resample epoch in every sweep and
   the launch counts; timings (kernel vs plain, the epoch flagged and
   unflagged, sweep time) and a profile of 8 back-to-back LG sweeps
   (``chiprun_out/lg_sweep_trace.json``);
5. one JSON line on the seven kernels, the card line, and the result line
   ``{"ok": true, "device": {...}}``.

Every timed sweep runs under ``torch.cuda.set_sync_debug_mode("error")``:
a sweep never waits on the host.  Launch counts are set to 0 just before
each path's sweeps and read just after.
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
# the continuous-state path: build_smc_run(make_fused_lg_ssm(), 2^24,
# chunk=8) on T = 16 observations of the linear-Gaussian model
LG_N = 1 << 24
LG_T = 16
LG_CHUNK = 8
LG_STEP_N = 1 << 20        # the per-step path (chunk = 1)
LG_STEP_SWEEPS = 8
PASS1_SLACK = 16           # start slots pass 1 may place differently


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


def _lg_obs(device):
    from cpprob_tpu_torch.models.linear_gaussian import simulate_observations

    return torch.as_tensor(simulate_observations(LG_T, 0), device=device)


def _lg_population(n, seed, obs):
    """The model's own t = 0 population on the card, from a seeded
    generator: x ~ N(0, 1), log_w = log N(y_0; x, 1)."""
    from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm as lg

    gen = torch.Generator(device=obs.device)
    gen.manual_seed(seed)
    x = lg.init_sample_batch(gen, n)
    return x, lg.obs_logpdf_batch(x, obs[0], 0)


def _lg_chunks(obs):
    from cpprob_tpu_torch.inference.smc import _chunk_observations

    ys, valid = _chunk_observations(obs, LG_CHUNK)
    return [y.contiguous() for y in ys], valid


def check_lg_kernels(n=LG_N, seed=CHECK_SEED):
    """K7, K6 and the epoch (K14, K15, K16) against their plain versions on
    the card, same seed and inputs, at the LG path's shapes.  States and
    weights must agree within 1e-5 (relative, and absolute on the unit
    scale of the states: eps from sincosf and torch's cos differ in the
    last bits); pass-1 slots may differ in at most ``PASS1_SLACK`` slots
    (float64 sums taken in another order); pass 2 must equal the exact
    expansion of its own start slots.  Returns the largest error of each
    kernel; raises on any disagreement."""
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.ops.fused_lg import (
        lg_chunk,
        lg_chunk_plain,
        lg_step,
        lg_step_plain,
    )

    dev = torch.device("cuda")
    obs = _lg_obs(dev)
    x0, w0 = _lg_population(n, seed, obs)
    ys, valid = _lg_chunks(obs)
    errs = {"lg_chunk": 0.0}
    eight = torch.full((), LG_CHUNK, dtype=torch.int32, device=dev)
    seven = torch.full((), LG_CHUNK - 1, dtype=torch.int32, device=dev)
    for t0, ys_c in ((1, ys[0]), (2, ys[0]), (9, ys[1])):
        for n_valid in (eight, seven):
            xk, wk, rk = lg_chunk(seed, x0, w0, ys_c, n_valid, t0=t0)
            xp, wp, rp = lg_chunk_plain(seed, x0, w0, ys_c, n_valid, t0=t0)
            _sync()
            what = f"lg_chunk n={n} t0={t0} n_valid={int(n_valid)}/{LG_CHUNK}"
            torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-5, msg=f"{what}: states")
            torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5, msg=f"{what}: log_w")
            _close_stats(rk, rp, n, what)
            err = float((wk - wp).abs().max())
            errs["lg_chunk"] = max(errs["lg_chunk"], err)
            print(f"check {what}: max|dx|={float((xk - xp).abs().max()):.3g} "
                  f"max|dlog_w|={err:.3g}")
            del xk, wk, xp, wp

    # K6: the one-step launch, and eight of them against one eight-step launch
    xk, wk = lg_step(seed, x0, w0, obs[1], 1)
    xp, wp = lg_step_plain(seed, x0, w0, obs[1], 1)
    _sync()
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-5, msg="lg_step: states")
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5, msg="lg_step: log_w")
    errs["lg_step"] = float((wk - wp).abs().max())
    for t0 in (1, 2):
        xs, ws = x0, w0
        for t in range(LG_CHUNK):
            xs, ws = lg_step(seed, xs, ws, ys[0][t], t0 + t)
        x8, w8, _ = lg_chunk(seed, x0, w0, ys[0], eight, t0=t0)
        _sync()
        if not (torch.equal(xs, x8) and torch.equal(ws, w8)):
            raise AssertionError(f"eight one-step launches at t0={t0} differ "
                                 "from one eight-step launch")
    print(f"check lg_step n={n}: max|dlog_w|={errs['lg_step']:.3g}; eight "
          "one-step launches equal one eight-step launch (t0 1 and 2)")

    # the epoch on the weights after the first chunk
    x1, w1, _ = lg_chunk(seed, x0, w0, ys[0], eight, t0=1)
    stats_k = sr.logsumexp_stats(w1)
    stats_p = sr.logsumexp_stats_plain(w1)
    _sync()
    if float(stats_k[0]) != float(stats_p[0]):
        raise AssertionError("lse_stats: max differs")
    torch.testing.assert_close(stats_k[1], stats_p[1], rtol=1e-12, atol=0,
                               msg="lse_stats: wtot")
    errs["lse_stats"] = float((stats_k - stats_p).abs().max())
    u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
    st_k = sr.resample_pass1(u0, w1, stats_k)
    st_p = sr.resample_pass1_plain(u0, w1, stats_p)
    _sync()
    d_st = (st_k.long() - st_p.long()).abs()
    n_diff = int((d_st > 0).sum())
    errs["pass1"] = float(d_st.max())
    print(f"check lse_stats n={n}: max|d|={errs['lse_stats']:.3g}; pass1: "
          f"{n_diff} start slots differ (at most {PASS1_SLACK} allowed), "
          f"max {errs['pass1']:.0f}")
    if n_diff > PASS1_SLACK or not bool((st_k[1:] >= st_k[:-1]).all()) \
            or int(st_k[0]) != 0:
        raise AssertionError("pass1: start slots differ or are not monotone")
    out_k = sr.resample_pass2(st_k, x1)
    counts = torch.diff(st_k.long(), append=torch.full((1,), n, device=dev))
    expand = torch.repeat_interleave(x1, counts)
    _sync()
    n_bad = int((out_k != expand).sum())
    print(f"check pass2 n={n}: {n_bad} slots differ from the exact expansion "
          "of the kernel's own start slots")
    if n_bad or not torch.equal(out_k, sr.resample_pass2_plain(st_k, x1)):
        raise AssertionError("pass2: not the exact expansion of its start slots")
    errs["pass2"] = 0.0
    # flag off: the epoch hands the population back unchanged
    off = torch.zeros((), dtype=torch.int32, device=dev)
    st_off = sr.resample_pass1(u0, w1, sr.logsumexp_stats(w1, off), off)
    if not torch.equal(sr.resample_pass2(st_off, x1, off), x1):
        raise AssertionError("pass2 with the flag off is not a copy")
    # one heavy particle: every slot holds its value
    lw = torch.full((n,), -100.0, device=dev)
    lw[12345] = 0.0
    heavy = sr.resample_pass2(sr.resample_pass1(u0, lw, sr.logsumexp_stats(lw)), x1)
    _sync()
    if not bool((heavy == x1[12345]).all()):
        raise AssertionError("pass2: the degenerate population is not one value")
    print("check epoch: flag off copies the population; one heavy particle "
          "fills every slot")
    return errs


def run_lg_path(run, obs, sweeps, counters, what):
    """``sweeps`` sweeps of ``run`` under sync-debug "error", with the
    launch counters set to 0 just before and read just after; checks logZ
    against the Kalman filter and at least one resample epoch in every
    sweep.  Returns (launches, times)."""
    import numpy as np

    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        simulate_observations,
    )

    run(40_000, obs)
    _sync()
    for c in counters:
        for name in c:
            c[name] = 0
    times, results = [], []
    for i in range(sweeps):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = run(i, obs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        times.append(time.perf_counter() - t0)
        results.append(res)
    launches = {name: v for c in counters for name, v in c.items()}
    zs = torch.stack([r.log_evidence for r in results]).cpu().numpy()
    epochs = torch.stack([r.resampled for r in results]).sum(1).cpu().numpy()
    exact = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
    if not np.isfinite(zs).all():
        raise AssertionError(f"{what}: non-finite logZ {zs}")
    mean, se = float(zs.mean()), float(zs.std(ddof=1) / math.sqrt(sweeps))
    tol = 4 * se + 0.02
    print(f"{what}: mean logZ={mean:.6f} SE={se:.3g} kalman={exact:.6f} "
          f"tol={tol:.4f}; resample epochs per sweep {epochs.tolist()}; "
          f"launches {launches}")
    if abs(mean - exact) > tol:
        raise AssertionError(f"{what}: logZ outside 4 SE + 0.02 of Kalman")
    if not (epochs >= 1).all():
        raise AssertionError(f"{what}: a sweep ran no resample epoch")
    return launches, times


def profile_sweeps(run, obs, card, sweeps=8, trace="sweep_trace.json"):
    """torch.profiler over ``sweeps`` back-to-back sweeps of ``run``: the
    trace goes to chiprun_out/``trace``; prints the device time by kernel
    and the device's busy share of the traced span."""
    from torch.profiler import ProfilerActivity, profile

    run(30_000, obs)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(sweeps):
            run(30_001 + i, obs)
        _sync()
    out = os.path.join(REPO, "chiprun_out", trace)
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


def build_kernels(stages):
    """Builds every kernel library from the sources, one nvcc per source,
    all started together; prints the ptxas register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from cpprob_tpu_torch.ops import _build, fused_hmm, fused_lg, stream_resample

    mods = (fused_hmm, fused_lg, stream_resample)
    with stages.stage("build", sync=True):
        with ThreadPoolExecutor(len(mods)) as pool:
            list(pool.map(lambda m: m._lib(), mods))
    print(f"build: {stages.totals['build']:.2f} s ({len(mods)} sources in parallel)")
    for name in ("fused_hmm", "fused_lg", "stream_resample"):
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}:", line.strip())


def hmm_phases(card, stages):
    """The HMM main path: kernel checks, the multi-chunk sweep, 16 sweeps
    of the main path, timings and the profile.  Returns the kernel lines."""
    import numpy as np

    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models import hmm_log_evidence, simulate_observations
    from cpprob_tpu_torch.ops import fused_hmm

    dev = torch.device("cuda")
    spec = _spec()
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

    src = "cpprob_tpu_torch/ops/csrc/fused_hmm.cu"
    return [
        {"name": "hmm_init_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:727",
         "launches": launches["init"], "max_abs_err": errs["init"],
         "ms": timing["init"][0], "plain_ms": timing["init"][1]},
        {"name": "hmm_chunk_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:245",
         "launches": launches["chunk"], "max_abs_err": errs["chunk"],
         "ms": timing["chunk"][0], "plain_ms": timing["chunk"][1]},
    ]


def lg_phases(card, stages):
    """The continuous-state path: kernel checks at 2^24, 16 sweeps of the
    LG main path (chunk 8), 8 sweeps of the per-step path (2^20), timings
    and the profile.  Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops import stream_resample as sr

    dev = torch.device("cuda")
    with stages.stage("lg_kernel_vs_plain", sync=True):
        errs = check_lg_kernels()
    obs = _lg_obs(dev)
    model = fused_lg.make_fused_lg_ssm()
    counters = (fused_lg.LAUNCHES, sr.LAUNCHES)
    run = build_smc_run(model, LG_N, ess_threshold=0.5,
                        resampling="systematic", chunk=LG_CHUNK)
    with stages.stage("lg_main_path", sync=True):
        launches, times = run_lg_path(
            run, obs, SWEEPS, counters,
            f"LG main path n={LG_N} T={LG_T} chunk={LG_CHUNK}")
    n_chunks = -(-(LG_T - 1) // LG_CHUNK)
    want = {"chunk": SWEEPS * n_chunks, "step": 0, "lse_stats": SWEEPS * n_chunks,
            "pass1": SWEEPS * n_chunks, "pass2": SWEEPS * n_chunks}
    if launches != want:
        raise AssertionError(f"LG launch counts {launches}, expected {want}")
    run1 = build_smc_run(model, LG_STEP_N, ess_threshold=0.5,
                         resampling="systematic", chunk=1)
    with stages.stage("lg_step_path", sync=True):
        step_launches, step_times = run_lg_path(
            run1, obs, LG_STEP_SWEEPS, counters,
            f"LG per-step path n={LG_STEP_N} T={LG_T} chunk=1")
    n_steps = LG_T - 1
    want = {"chunk": 0, "step": LG_STEP_SWEEPS * n_steps,
            "lse_stats": LG_STEP_SWEEPS * n_steps,
            "pass1": LG_STEP_SWEEPS * n_steps, "pass2": LG_STEP_SWEEPS * n_steps}
    if step_launches != want:
        raise AssertionError(f"per-step launch counts {step_launches}, expected {want}")

    sweep_s = statistics.median(times)
    print(f"[{card}] LG median sweep {sweep_s * 1e3:.3f} ms, "
          f"{LG_N * LG_T / sweep_s:.6g} particle-steps/s (n={LG_N}, T={LG_T}, "
          f"chunk={LG_CHUNK}, {SWEEPS} sweeps, host clock, synced per sweep)")
    b2b_ms = _time_ms(lambda: run(20_000, obs), SWEEPS)
    print(f"[{card}] LG back-to-back sweeps: {b2b_ms:.4f} ms each by CUDA "
          f"events, {LG_N * LG_T / (b2b_ms * 1e-3):.6g} particle-steps/s")
    step_s = statistics.median(step_times)
    step_b2b = _time_ms(lambda: run1(21_000, obs), LG_STEP_SWEEPS)
    print(f"[{card}] LG per-step median sweep {step_s * 1e3:.3f} ms (host "
          f"clock), back-to-back {step_b2b:.4f} ms by CUDA events, "
          f"{LG_STEP_N * LG_T / (step_b2b * 1e-3):.6g} particle-steps/s "
          f"(n={LG_STEP_N})")

    # -- kernel vs plain time at the path's shapes: the first chunk's inputs,
    # and the epoch on the weights after it --
    seed = CHECK_SEED
    x0, w0 = _lg_population(LG_N, seed, obs)
    ys, valid = _lg_chunks(obs)
    x1, w1, _ = fused_lg.lg_chunk(seed, x0, w0, ys[0], valid[0], t0=1)
    stats = sr.logsumexp_stats(w1)
    u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
    st = sr.resample_pass1(u0, w1, stats)
    timing = {
        "lg_chunk": (
            _time_ms(lambda: fused_lg.lg_chunk(seed, x0, w0, ys[0], valid[0], t0=1), 10),
            _time_ms(lambda: fused_lg.lg_chunk_plain(seed, x0, w0, ys[0], valid[0], t0=1), 2)),
        "lg_step": (
            _time_ms(lambda: fused_lg.lg_step(seed, x0, w0, obs[1], 1), 10),
            _time_ms(lambda: fused_lg.lg_step_plain(seed, x0, w0, obs[1], 1), 2)),
        "lse_stats": (
            _time_ms(lambda: sr.logsumexp_stats(w1), 10),
            _time_ms(lambda: sr.logsumexp_stats_plain(w1), 4)),
        "pass1": (
            _time_ms(lambda: sr.resample_pass1(u0, w1, stats), 10),
            _time_ms(lambda: sr.resample_pass1_plain(u0, w1, stats), 4)),
        "pass2": (
            _time_ms(lambda: sr.resample_pass2(st, x1), 10),
            _time_ms(lambda: sr.resample_pass2_plain(st, x1), 4)),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name} at n={LG_N}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")

    def epoch(flag):
        s = sr.logsumexp_stats(w1, flag)
        return sr.resample_pass2(sr.resample_pass1(u0, w1, s, flag), x1, flag)

    on = torch.ones((), dtype=torch.int32, device=dev)
    off = torch.zeros((), dtype=torch.int32, device=dev)
    print(f"[{card}] epoch at n={LG_N} (K14 + K15 + K16): flagged "
          f"{_time_ms(lambda: epoch(on), 10):.4f} ms, unflagged "
          f"{_time_ms(lambda: epoch(off), 10):.4f} ms")
    with stages.stage("lg_profile", sync=True):
        profile_sweeps(run, obs, card, trace="lg_sweep_trace.json")

    def line(name, key, replaces, src, n_launch):
        return {"name": name, "route": "cuda",
                "source": f"cpprob_tpu_torch/ops/csrc/{src}",
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": errs[key], "ms": timing[key][0],
                "plain_ms": timing[key][1]}

    return [
        line("lg_chunk_kernel", "lg_chunk", "cpprob_tpu/ops/pallas_hmm.py:808",
             "fused_lg.cu", launches["chunk"]),
        line("lg_chunk_kernel (n_steps=1, lg_step)", "lg_step",
             "cpprob_tpu/ops/pallas_hmm.py:669", "fused_lg.cu",
             step_launches["step"]),
        line("lse_stats_kernel + lse_combine_kernel", "lse_stats",
             "cpprob_tpu/ops/pallas_resample.py:727", "stream_resample.cu",
             launches["lse_stats"]),
        line("pass1_tile_sums/scan_tiles/finish_kernel", "pass1",
             "cpprob_tpu/ops/pallas_resample.py:113", "stream_resample.cu",
             launches["pass1"]),
        line("pass2_kernel", "pass2", "cpprob_tpu/ops/pallas_resample.py:645",
             "stream_resample.cu", launches["pass2"]),
    ]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    from cpprob_tpu_torch.util.profiling import (
        StageTimer,
        env_versions,
        gpu_name_and_power,
    )

    card = gpu_name_and_power()
    print(card)
    print("versions:", json.dumps(env_versions()))
    stages = StageTimer()
    build_kernels(stages)
    kernels = hmm_phases(card, stages) + lg_phases(card, stages)
    print(stages.report())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
