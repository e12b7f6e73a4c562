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
   threshold that splits the islands, and the main path's launch from t0
   = 2, 3 and 4 besides 1 (the transition draws come four steps from a
   Philox call, so each start cuts the groups elsewhere); the chunk
   against its own one-step launches, bit for bit (``check_chunk_steps``:
   t0 4 to 7, island checks off and never firing); a multi-chunk sweep
   (chunk 4) whose
   boundary resamples go through the flag and ticks;
   ``build_smc_run(make_fused_hmm_ssm(island_every=8), 2^26, chunk=16)`` on
   the headline benchmark's observations (T = 16) for 16 sweeps, checked
   against the exact forward-recursion evidence, with the kernels' launch
   counts and the interior island resamples of those sweeps; timings
   (kernel vs plain, sweep time, particle-steps/s) and a
   ``torch.profiler`` trace of 8 back-to-back sweeps
   (``chiprun_out/sweep_trace.json``: device time by kernel, busy share);
   before them, the SASS of the two kernels redesigned last
   (``check_sass``): ``tensor_core_kernel`` is wgmma alone (``HGMMA``, no
   ``HMMA``), ``pass1_scan_kernel``'s double-precision instructions a
   particle and ``lse_stats_kernel``'s a weight (in its batch loop) match
   their bounds' counts, and each chain kernel instance's
   registers and local memory (``check_chain_sass``: none in
   ``hmm_chunk_kernel<K>``, ``hmm_chunk_kernel_k`` and
   ``guided_chunk_kernel<K>``);
4. the continuous-state path (``lg_phases``): at 2^24 particles, the LG
   chunk kernel against its plain version (t0 odd, even and 9, n_valid 8
   and 7), the one-step launch (and eight of them against one eight-step
   launch, bit for bit), the one-step launch with the step's resample
   control (``check_lg_step_ctrl``: flag off and on, bit-equal to the
   launch without it on the weights a reset leaves, the ESS of its last
   CTA's combine, the next flag, its ticket over 16 launches and on a
   second stream), the sweep's start (``check_lg_init``: at 1,000, 2^16 +
   3 and 2^24 particles, bit-equal to the one-step launch at t = 0 on zero
   states and to the plain version, the ESS of its last CTA's combine, the
   first flag, its ticket, also on a second stream), the epoch's stats,
   pass-1 and pass-2 kernels
   (the stats kernel, one launch whose last CTA combines the records: its
   max bit-equal and wtot within 1e-12, 16 calls bit-equal, at 2^24 - 3,
   on a view at a one-float offset, with a block of -inf weights, and flag
   0 then 1, the ticket and records untouched by flag 0;
   pass 2 against the exact expansion of its own start slots, the flag off
   and one heavy particle; pass 1, the single-pass scan, 64 times back to
   back, at the ragged sizes 1, 4,097 and 2^20 + 3, with one heavy
   particle, with all weights but one at -inf, and flag off then on); ``build_smc_run(make_fused_lg_ssm(), 2^24,
   chunk=8)`` on T = 16 observations of the model for 16 sweeps, and the
   per-step path (chunk = 1) at 2^20 for 8 sweeps, each checked against
   the Kalman filter's evidence, with a resample epoch in every sweep and
   the launch counts; timings (kernel vs plain, the epoch flagged and
   unflagged, sweep time) and two profiles of 8 back-to-back LG sweeps
   (``chiprun_out/lg_sweep_trace.json``, the second);
5. the kernel-from-spec family (``spec_phases``): K9 and K8 against their
   plain versions for K = 5 at 2^24 (8- and 16-slot chunks), K = 12 and 32
   at 2^20 (4-slot chunks) and K = 1, the flag off and on, n_valid short,
   the island check forced, at 0.5 and at 0.0, from t0 = 1 to 4; K = 5
   and 12 against their one-step launches; K4 and K5 (one-step
   launches of the chunk kernel behind the HMM's per-step hooks) against
   ``hmm_chunk_plain`` at n_steps = 1; path 1,
   ``build_smc_run(make_fused_discrete_ssm(5-state chain), 2^24,
   chunk=8)`` on ``examples/kernel_bench.py``'s observations, and path 2,
   the same with ``island_every=8`` and ``chunk=16``, for 16 sweeps each;
   path 3, K = 12 and 32 at 2^20 (chunk 4, T = 12), path 4, the HMM per
   step at 2^20 (``build_smc_run(..., chunk=1)``, K4, and ``smc()``, K5),
   for 8 sweeps each; each against the exact forward recursion, with
   launch counts and resamples; timings and a profile of path 1
   (``chiprun_out/spec_sweep_trace.json``);
6. the user-physics family (``user_phases``): K10 (the LG physics, and a
   non-linear one, rendered to CUDA from the ``step_elem``) against its
   plain version and against K7 on the same draws; K11 (the 2-D
   linear-Gaussian model) against its plain version; their libraries'
   registers, spills and local memory (``check_user_sass``); path 5,
   ``build_smc_run(attach_fused_scalar_kernels(linear_gaussian_ssm,
   lg_step_elem), 2^24, chunk=8)`` for 16 sweeps against Kalman, path 6,
   ``attach_fused_vector_kernels(2-D model, step, 2)`` at 2^20, chunk 4,
   for 8 sweeps against the 2-D Kalman filter; timings beside K7, in turns;
7. guided SMC (``guided_phases``): the two proposal nets trained on the
   card by ``train_ssm_proposal`` with ``examples/kernel_bench.py``'s
   settings (a set-up stage; fails unless the loss fell); K12 (CUDA
   generated per net, the net on the FMA pipe: the guided linear-Gaussian
   model, t0 1 and 9, n_valid 8 and 7; a linear ``[3, 2]`` head, a
   ``[3,64,64,2]`` net and a density with ``**``; each build's SASS must
   show no spill and no local memory beyond the precise ``sincosf``'s
   slow-path frame, ``check_scalar_sass``), its
   tensor-core twin (CUDA ``guided_tc_kernel``: one step on path 7's net
   and four random nets, ``TC_NETS``, and in its wide layout on
   ``TC_WIDE_NETS`` ([3,48,48,2], [3,64,64,2]), within ``TC_STEP_TOL``,
   where its 1xTF32 variant must fail; its chunks against its own
   one-step launches, bit for bit; each build's SASS must show TF32
   ``HMMA`` and no local memory, ``check_tc_sass``) and K13
   (CUDA: the tables kernel, one CTA a step, row by row against
   ``guided_tables_plain``, then the chunk kernel on the guided 5-state
   chain: flag 0 and 1, n_valid 8 and 7, island off, and a 16-slot chunk
   whose forced island check fires, from t0 = 1 to 4, and against its
   one-step launches; its one-step
   launch at 2^20; its instances for K = 2, 3, 8 at 2^20 with untrained
   nets, and K = 1, a [7, 128, 128, 128, 5] net and a [7, 2048, 5] one)
   against their plain versions at 2^24; path 7,
   ``build_smc_run(attach_fused_guided_scalar_kernels(...), 2^24,
   chunk=8)`` against Kalman, with ``mxu=True`` (the twin, the default)
   and with ``mxu=False`` (K12 on the FMA pipe); path 7w, the same under
   the benchmark's committed ``[3,64,64,2]`` net with each kernel (the
   twin's launches counted under ``guided_tc.wide``, none under
   ``guided_tc.guided_tc``); one query of the benchmark cell
   ``guided-lg-2e24-chunk8`` whose launches are held per particle to the
   cell's plain reference (``check_guided_lg_cell``: the 1xTF32 twin and
   the reference with TF32 operands must fail); path 8, ``build_smc_run(
   attach_fused_guided_discrete_kernels(...), 2^24, chunk=8)`` (K9 then
   K13); path 9a, the same model per step at 2^20 (K13 one-step launches,
   T = 12); path 9b, ``island_every=8`` at ``chunk=16`` (the interior
   check must fire in the path's own sweeps); path 9c, ``smc()`` with
   history (the engine's unfused guided step: no kernel); each against the
   exact forward recursion or Kalman, with launch counts; timings (K13
   beside K8 at path 8's shapes, in turns; the tables kernel alone) and
   profiles of paths 7 and 8 (``chiprun_out/guided_lg_sweep_trace.json``,
   ``chiprun_out/guided_chain_sweep_trace.json``);
8. the pass-2 variants (``r1_phases``, R1): ``pass2_tile_kernel`` (K16's
   kernel) with ``impl="fast"`` and ``impl="merge"`` (its per-tile
   column-major layout) against their plain versions at 2^24 on the LG
   path's weights (flag on, off and absent, one heavy particle, the first
   start slot past 0; 0 slots may differ);
   ``streaming_systematic_resample_values(impl=...)`` for 8 epochs of each
   variant, counted; timings of the three layouts beside
   ``torch.repeat_interleave``; then the four benchmark cells' queries as
   their main path runs them, a captured CUDA graph replayed
   (``replay_phases``): each replay under sync-debug "error" equal bit for
   bit to the eager query of its seed, its launches counted as the eager
   query's, one capture a cell, and the graph's memory pool printed;
9. the distribution layer (``distribution_phases``, slice 4a, plain
   PyTorch): 2^24 draws of each scalar class, the mixtures, both
   truncations and the spline flow, and 2^20 of each multivariate normal
   (D = 8), from a CUDA generator; moments within 6 SE of the analytic
   ones (by quadrature where there is no closed form), ``log_prob`` and
   ``cdf`` (``betainc`` for the beta) on the card against the same
   draws' on the CPU; the times of ``sample`` and ``log_prob``;
10. the trace substrate and SIS (``sis_phases``, slice 4b, plain PyTorch
   under ``torch.func.vmap``, no kernel of its own): ``sis`` at 2^20
   particles (the JAX README's headline call) on the README Gaussian
   (mean, variance and log-evidence against 2.32353 / 1.05882 and the
   analytic marginal), the 2-D Gaussian, ``hmm`` and ``hmm_scan`` on the
   headline observations (log-evidence against -26.44222, smoothed
   marginals within 0.03 of forward-backward, one draw order in both) and
   both rejection models (their host reads counted); ``sis_streaming`` at
   2^24 in chunks of 2^20 on the LG model and ``smc`` through the LG
   model's per-particle hooks at 2^20, both against Kalman; 4 SE + 0.02
   over 4 seeds (8 for the streaming call); each model's ms a call,
   launches, busy share (``chiprun_out/sis_*_trace.json``) and peak memory;
11. inference compilation (``csis_phases``, slice 5, plain PyTorch, no
   kernel of its own) at the reference's widths (embedding 128, a 2-layer
   LSTM of 128): ``CSIS`` trained on the card on the README Gaussian (300
   Adam steps at batch 256), ``hmm`` and the tied ``hmm_scan`` at T = 16
   (400 steps each), ``infer`` at 2^20 against the conjugate posterior, the
   exact log-evidence and the forward-backward marginals over 4 seeds, the
   ESS against the prior ``sis``'s, ``defensive=0.1``, ``infer_many``
   against the single calls; offline training from 2^14 dumped traces
   through the native ``TraceLoader``, a checkpoint reload equal bit for
   bit; ``DynamicCSIS`` on ``tests/test_csis_dynamic.py``'s model; the
   entry twin; training ms a step and traces/s, ms an ``infer`` call,
   launches, busy share (``chiprun_out/csis_*_trace.json``), peak memory;
12. the gradient-based and second-level engines (``engine_phases``, slice
   6, plain PyTorch under ``torch.func.vmap`` and ``torch.func.grad``, no
   kernel of its own): the log-joint and its gradient at 4,096 positions
   against the CPU's; ``hmc`` (4,096 chains) on the README Gaussian and
   beta-Bernoulli, ``chees_hmc`` (4,096 chains, up to 64 leapfrogs),
   ``nuts`` (1,024 chains, depth 6) on the README and the anisotropic
   Gaussian, ``svi`` mean-field over 4 seeds and full-rank, the
   posterior predictive over the HMC draws and the prior predictive at
   2^20, ``smc_sampler`` at 2^20 (3 moves, waste-free, beta-Bernoulli),
   ``particle_gibbs`` on the HMM (1,024 particles, 600 iterations) and
   ``smc2`` at 1,024 x 1,024, each against its JAX test's oracle and
   tolerance (4 SE + 0.02 over 4 seeds where an evidence is exact); each
   engine's ms a call, ms a gradient, launches a transition, stage or
   iteration, busy share (``chiprun_out/engine_*_trace.json``), peak
   memory and host reads;
13. multi-device execution (``parallel_phases``, slice 7, no kernel of
   its own; the chunked sharded path runs the model's chunk kernel on each
   rank): at world size 1 over NCCL in this process, ``smc_sharded(
   make_fused_lg_ssm(), ..., 2^24, chunk=8)`` under ``balanced``,
   ``collective`` and ``island`` (4 seeds each against Kalman; balanced
   equal to collective bit for bit), path 7's guided LG model on K12's
   tensor-core twin under ``balanced``, the HMM per step at 2^20 under
   ``exchange`` and ``island`` (the HMM's chunked sharded sweep refused, as
   the reference's), ``sis_sharded`` on the README Gaussian at 2^20,
   ``CSIS.compile(mesh=)`` and ``infer(mesh=)``, each under sync-debug
   "error" (the counted reads of ``HOST_READS["smc_sharded"]`` allowed),
   timed beside its single-device call; then two gloo worker processes
   sharing the card (``--parallel-worker``: ``dryrun_multichip(2)``, the LG
   sweep at 2^24 in total under ``balanced`` and ``collective``, equal bit
   for bit across the processes, each rank's K7 chunk against its plain
   version with the rank's own seed, the bytes an epoch sends), each with
   its own timeout;
14. the drivers (``driver_phases``, slice 8, no kernel of its own; the
   kernel_bench twin's paths run ten of the kernels above): ``cli.main``
   on the card (``sis`` on the README Gaussian at 2^20 against 2.32353 /
   1.05882, twice, ``smc`` on the HMM at 2^20 over 4 seeds against the
   forward recursion, ``compile`` then ``csis`` (2^18) on the HMM with
   the checkpoint and the posterior dump in a fresh temporary directory,
   the dump's smoothed marginals within 0.03 of forward-backward,
   ``estimate`` on the dump);
   the ``sherpa_fullscale`` twin at the full 35x35x20 volume with 4,096
   deposits (CNN3D-embedded CSIS, 300 steps at batch 32, then prior SIS
   and guided ``infer`` at 512 particles for four channels, five tempers
   and four defensive weights) with the reference's gate, traces/s, ms an
   ``infer``, launches, busy share (``chiprun_out/
   driver_sherpa_infer_trace.json``) and peak memory; the
   ``external_simulator`` twin in full mode with its gates, the exchanges
   and host reads of a guided call; the ``kernel_bench`` twin at 2^20,
   each path's logZ within 4 SE + 0.02 of its exact value and its
   kernels' launches counted on its own sweeps (``chiprun_out/driver.json``);
15. the card's calibration (``roofline_phases``, K17-K21): each
   calibration kernel against its plain version at a reduced size (K17,
   K19, K20b exactly; K18, K20a, K21 within the tolerances stated at
   ``CAL_*``), then ``util/roofline.py``'s ``calibrate_peaks`` at the
   reference's sizes, counted; the peaks must be positive and below the
   datasheet's where it has one;
16. the ``roofline`` JSON line: the peaks, the card, and for every kernel
   entry its bound against the published peaks and its calibrated bound
   (``analyze_kernels``: the binding resource and the fraction, at most 1);
   the whole analysis in ``chiprun_out/roofline.json``;
17. one JSON line on the 26 kernel entries (each with ``bound_ms``,
   ``bound_by``, ``library_ms`` where one PyTorch call computes the same
   function, ``calibrated_bound_ms`` and ``calibrated_by``), the card line,
   and the result line ``{"ok": true, "device": {...}}``.

Every timed sweep, every SIS call, every CSIS training step and
``infer`` call, and every engine call runs under
``torch.cuda.set_sync_debug_mode("error")``: none waits on the host (a
rejection round's one host read, and NUTS's, the tempered sampler's and
SMC²'s reads of a loop's flag, are the counted exceptions; the
dynamic-structure path reads sampled values by design and runs outside
it; so do the drivers of phase 14, which run as a user runs them and read
their results back).  Launch counts are set to 0 just before
each path's sweeps and read just after; launches made to compare a kernel
with its plain version are not counted on the ``kernels`` line.
It needs a CUDA device and never falls back to the CPU.
"""

import itertools
import json
import math
import os
import statistics
import sys
import time

import torch

from cpprob_tpu_torch.models.linear_gaussian import obs_logpdf_elem as guided_obs_lp
from cpprob_tpu_torch.models.linear_gaussian import trans_logpdf_elem as guided_trans_lp
from cpprob_tpu_torch.ops import elem
from cpprob_tpu_torch.util.roofline import time_ms

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
# double-precision instructions a particle in pass1_scan_kernel's SASS:
# DFMA 242, DADD 162, DSETP 54, DMUL 53 over the 16 particles a thread takes
# (the float64 exp is ~15 DFMA of range reduction and polynomial, its scale
# and special-case tests; then the prefix adds, the slot arithmetic, and
# the thread's share of the scans and the look-back; a static count, so the
# exp's rarely taken branches are in it), read on an H100 80GB HBM3 at
# 700.00 W; check_sass reads it again from the build
PASS1_F64_OPS = 511 / 16
# double-precision instructions a weight in lse_stats_kernel's batch loop:
# DFMA 119, DADD 50, DMUL 18, DSETP 17 in its largest loop, over the 16
# weights of a batch (each weight's exp_nonpos, ten, and its add; the
# batch's rescale), read on an H100 80GB HBM3 at 700.00 W; check_sass reads
# it again from the build
LSE_F64_OPS = 204 / 16

# The kernels' work by resource and their bounds (bound_ms against the
# published peaks, calibrated_bound_ms against the card's own calibration)
# live in cpprob_tpu_torch/util/roofline.py; each phase imports them there.
# Entries read on the roofline line only (a kernel's other configuration,
# not a kernel of its own: K3 is K2's kernel without the island check).
ROOFLINE_EXTRA = []
# the proposal nets train_guides trained, by name ("lg", "chain"), for the
# phases after the guided one
TRAINED_NETS = {}


def _sync():
    torch.cuda.synchronize()


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
    from cpprob_tpu_torch.ops.fused_hmm import hmm_chunk, hmm_chunk_plain

    dev = torch.device("cuda")
    spec = _spec()
    K = spec.K
    obs = _observations(dev)
    s_k, w_k, err = _check_init(seed, obs[0], n, spec, f"init n={n}")
    errs = {"init": err, "chunk": 0.0}
    ys, n_valid = _main_chunk(obs)
    cases = []
    for flag in (0, 1):
        ctrl = torch.tensor([flag, n // 3, 2 * n // 3, int(n_valid)],
                            dtype=torch.int32, device=dev)
        split, margin = _split_thresh(seed, s_k, w_k, ys, ctrl)
        print(f"flag={flag}: split threshold {split:.6f}, half-gap "
              f"{margin:.3g} of it")
        cases += [(ctrl, 0, 0.5, None), (ctrl, ISLAND_EVERY, 2.0, 1.0),
                  (ctrl, ISLAND_EVERY, 0.5, None), (ctrl, ISLAND_EVERY, 0.0, 0.0),
                  (ctrl, ISLAND_EVERY, split, "splits")]
    # n_valid 8: the t = 7 check sees t + 1 = n_valid and must not fire
    ctrl = torch.tensor([0, n // 3, 2 * n // 3, ISLAND_EVERY],
                        dtype=torch.int32, device=dev)
    cases.append((ctrl, ISLAND_EVERY, 2.0, 0.0))
    cases = [(1, *c) for c in cases]
    # the main path's launch from t0 = 2, 3, 4 (mod 4: 2, 3, 0; t0 = 1 above):
    # the first and the cut groups of four steps move with the start
    cases += [(t0, *cases[2][1:]) for t0 in (2, 3, 4)]
    cases.append((3, *cases[1][1:]))

    for t0, ctrl, island_every, thresh, want in cases:
        kw = dict(t0=t0, island_every=island_every, island_thresh=thresh)
        out_k = hmm_chunk(seed, s_k, w_k, ys, ctrl, spec, **kw)
        out_p = hmm_chunk_plain(seed, s_k, w_k, ys, ctrl, spec, **kw)
        _sync()
        what = (f"chunk n={n} t0={t0} flag={int(ctrl[0])} n_valid={int(ctrl[-1])}/"
                f"{ys.shape[0]} island_every={island_every} thresh={thresh:.6g}")
        errs["chunk"] = max(errs["chunk"], _compare_chunk(out_k, out_p, K, n,
                                                          what, want))
        del out_k, out_p
    ctrl = torch.tensor([1, n // 3, 2 * n // 3, int(n_valid)], dtype=torch.int32,
                        device=dev)
    check_chunk_steps(
        lambda s, w, y, c, t0, every, thresh: hmm_chunk(
            seed, s, w, y, c, spec, t0=t0, island_every=every, island_thresh=thresh),
        s_k, w_k, ys, ctrl, K, f"K2 n={n}")
    return errs


def check_chunk_steps(chunk, s0, w0, ys, ctrl, K, what, every=ISLAND_EVERY):
    """A chunk kernel on the card against its steps launched one at a time
    (the chunk's flag and ticks on the first launch, flag 0 after, up to
    n_valid), bit for bit in states, weights and records: from t0 = 4, 5, 6,
    7 (0 to 3 mod 4), without island checks and with checks every
    ``every`` steps that never fire (thresh 0: the kernel ends its tiles
    there and draws the cut group of four steps again).  ``chunk(s, w, ys,
    ctrl, t0, island_every, thresh)`` launches the kernel."""
    n_valid = int(ctrl[K])
    for t0 in (4, 5, 6, 7):
        for island_every, thresh in ((0, 0.5), (every, 0.0)):
            out = chunk(s0, w0, ys, ctrl, t0, island_every, thresh)
            s, w, rec = s0, w0, None
            for t in range(n_valid):
                c = ctrl.clone()
                c[K] = 1
                if t:
                    c[0] = 0
                s, w, rec = chunk(s, w, ys[t:t + 1].contiguous(), c, t0 + t, 0, 0.5)
            _sync()
            if not all(torch.equal(a, b) for a, b in zip(out, (s, w, rec))):
                raise AssertionError(f"{what} t0={t0} island_every={island_every}: "
                                     f"the chunk differs from its one-step launches")
            del out, s, w, rec
    print(f"check {what}: each chunk (t0 4 to 7, n_valid {n_valid}/{ys.shape[0]}, "
          f"island checks off and every {every} at thresh 0) equals its "
          f"{n_valid} one-step launches, bit for bit")


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
    errs["lg_step_ctrl"] = check_lg_step_ctrl(n, seed)

    # the epoch on the weights after the first chunk
    x1, w1, _ = lg_chunk(seed, x0, w0, ys[0], eight, t0=1)
    errs["lse_stats"] = check_lse_stats(w1)
    stats_k = sr.logsumexp_stats(w1)
    u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
    errs["pass1"] = check_pass1(w1, n)
    st_k = sr.resample_pass1(u0, w1, stats_k)
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


def check_lg_init(n=LG_N, seed=CHECK_SEED, repeats=16):
    """The sweep's start (``lg_init_kernel``) on the series' y_0 at ``n``
    particles: states, weights and records bit-equal to K7's one-step
    launch at absolute time 0 on zero states and weights, and the states
    and weights bit-equal to ``lg_init_plain``; the ESS within 1e-12
    (relative) of ``stats_from_partials`` on the launch's own records; the
    first flag that of the ESS at the sweep's threshold and on either side
    of the ESS; ``repeats`` launches bit-equal to the first, and the ticket
    0 after them, also on a second stream.  Returns the largest |dlog_w|
    against the plain version (0.0)."""
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops.fused_hmm import stats_from_partials
    from cpprob_tpu_torch.ops.population import current_stream

    obs = _lg_obs(torch.device("cuda"))
    dev, y0 = obs.device, obs[0]
    what = f"lg_init n={n}"

    def init(thresh):
        return fused_lg._init_launch(seed, n, y0, thresh)

    def ticket():
        return int(fused_lg._TICKETS[(dev, current_stream(dev).value)])

    x, w, ess, nxt, rec = init(0.5 * n)
    zeros = torch.zeros(n, device=dev)
    xr, wr, rr = fused_lg.lg_chunk(seed, zeros, zeros, y0.reshape(1), t0=0)
    xp, wp, ess_p, nxt_p = fused_lg.lg_init_plain(seed, n, y0, 0.5 * n)
    _sync()
    if not (torch.equal(x, xr) and torch.equal(w, wr) and torch.equal(rec, rr)):
        raise AssertionError(f"{what}: differs from the one-step launch at t = 0")
    err = float((w - wp).abs().max())
    if not (torch.equal(x, xp) and torch.equal(w, wp)):
        raise AssertionError(f"{what}: {int((x != xp).sum())} states and "
                             f"{int((w != wp).sum())} weights differ from the plain "
                             f"version (max|dlog_w| {err:.3g})")
    torch.testing.assert_close(ess, stats_from_partials(rec, n)[0], rtol=1e-12,
                               atol=0, msg=f"{what}: ess")
    if int(nxt) != int(float(ess) < 0.5 * n) or int(nxt) != int(nxt_p):
        raise AssertionError(f"{what}: first flag {int(nxt)}, ESS {float(ess)}, "
                             f"plain {int(nxt_p)}")
    for thresh in (0.999 * float(ess), 1.001 * float(ess)):
        _, _, e2, n2, _ = init(thresh)
        _sync()
        if not torch.equal(e2, ess) or int(n2) != int(float(ess) < thresh):
            raise AssertionError(f"{what}: threshold {thresh} gives {int(n2)}")
    outs = [init(0.5 * n) for _ in range(repeats)]
    _sync()
    if not all(torch.equal(o[1], w) and torch.equal(o[2], ess)
               and torch.equal(o[3], nxt) for o in outs) or ticket():
        raise AssertionError(f"{what}: {repeats} launches differ or leave the "
                             f"ticket at {ticket()}")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        outs = [init(0.5 * n) for _ in range(4)]
        left = ticket()
    _sync()
    if left or not all(torch.equal(o[2], ess) and torch.equal(o[3], nxt) for o in outs):
        raise AssertionError(f"{what}: a second stream differs or leaves its ticket set")
    print(f"check {what}: bit-equal to the one-step launch at t = 0 and to the "
          f"plain version, ESS {float(ess):.10g} (plain {float(ess_p):.10g}), "
          f"first flag {int(nxt)}, tickets clean over {repeats} launches and on a "
          "second stream")
    return err


def check_lg_step_ctrl(n=LG_N, seed=CHECK_SEED, repeats=16):
    """K6 with the step's resample control against the launch without it
    and the plain version, at t = 1 on the model's own t = 0 population,
    with the flag off and on: states, weights and records bit-equal to the
    launch without control on the weights the caller's reset would leave
    (within 1e-5 of the plain version); a set flag reads no old weight;
    the ESS within 1e-12 (relative) of ``stats_from_partials`` on the
    launch's own records; the next flag that of the ESS and equal to the
    plain version's; ``repeats`` launches bit-equal to the first, and the
    ticket 0 after them, also on a second stream.  Returns the largest
    |dlog_w| against the plain version."""
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops.fused_hmm import stats_from_partials
    from cpprob_tpu_torch.ops.population import current_stream

    obs = _lg_obs(torch.device("cuda"))
    x0, w0 = _lg_population(n, seed, obs)
    dev = x0.device           # with its index: the ticket's key
    y = obs[1]
    err = 0.0

    def ctrl(w, flag, thresh):
        return fused_lg._launch(seed, x0, w, y.reshape(1), None, 1,
                                "lg_step_ctrl check", "step_ctrl",
                                flag=flag, threshold=thresh)

    def ticket():
        return int(fused_lg._TICKETS[(dev, current_stream(dev).value)])

    for f in (0, 1):
        flag = torch.full((), f, dtype=torch.int32, device=dev)
        # the threshold just above and below the launch's ESS sets both flags
        xk, wk, ess, nxt, rec = ctrl(w0, flag, 0.5 * n)
        xr, wr, rr = fused_lg.lg_chunk(seed, x0, torch.zeros_like(w0) if f else w0,
                                      y.reshape(1), t0=1)
        xp, wp, ess_p, nxt_p = fused_lg.lg_step_ctrl_plain(
            seed, x0, w0, y, 1, flag, 0.5 * n)
        _sync()
        what = f"lg_step_ctrl n={n} flag={f}"
        if not (torch.equal(xk, xr) and torch.equal(wk, wr) and torch.equal(rec, rr)):
            raise AssertionError(f"{what}: differs from the launch without control")
        torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-5, msg=f"{what}: states")
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5, msg=f"{what}: log_w")
        err = max(err, float((wk - wp).abs().max()))
        want = stats_from_partials(rec, n)[0]
        torch.testing.assert_close(ess, want, rtol=1e-12, atol=0, msg=f"{what}: ess")
        if int(nxt) != int(float(ess) < 0.5 * n) or int(nxt) != int(nxt_p):
            raise AssertionError(f"{what}: next flag {int(nxt)}, ESS {float(ess)}, "
                                 f"plain {int(nxt_p)}")
        for thresh in (0.999 * float(ess), 1.001 * float(ess)):
            _, _, e2, n2, _ = ctrl(w0, flag, thresh)
            _sync()
            if not torch.equal(e2, ess) or int(n2) != int(float(ess) < thresh):
                raise AssertionError(f"{what}: threshold {thresh} gives {int(n2)}")
        if f:
            # the old weights are not read
            _, w_far, _, _, _ = ctrl(w0 + 5.0, flag, 0.5 * n)
            _sync()
            if not torch.equal(w_far, wk):
                raise AssertionError(f"{what}: a set flag read the old weights")
        outs = [ctrl(w0, flag, 0.5 * n) for _ in range(repeats)]
        _sync()
        same = all(torch.equal(o[1], wk) and torch.equal(o[2], ess)
                   and torch.equal(o[3], nxt) for o in outs)
        if not same or ticket():
            raise AssertionError(f"{what}: {repeats} launches differ or leave "
                                 f"the ticket at {ticket()}")
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            outs = [ctrl(w0, flag, 0.5 * n) for _ in range(4)]
            left = ticket()
        _sync()
        if left or not all(torch.equal(o[2], ess) and torch.equal(o[3], nxt)
                           for o in outs):
            raise AssertionError(f"{what}: a second stream differs or leaves "
                                 "its ticket set")
        print(f"check {what}: bit-equal to the launch without control, "
              f"max|dlog_w| to plain {float((wk - wp).abs().max()):.3g}, ESS "
              f"{float(ess):.10g} (plain records {float(ess_p):.10g}), next "
              f"flag {int(nxt)}; {repeats} launches and a second stream alike, "
              "tickets 0")
    return err


def _check_lse(lw, what, repeats=1, flag=None):
    """K14 on ``lw`` against ``logsumexp_stats_plain``: the max bit-equal,
    wtot within rtol 1e-12, and ``repeats`` more calls bit-equal to the
    first.  Returns (max |kernel - plain| over (m, wtot), |d wtot| / wtot)."""
    from cpprob_tpu_torch.ops import stream_resample as sr

    got = sr.logsumexp_stats(lw, flag)
    want = sr.logsumexp_stats_plain(lw)
    again = [sr.logsumexp_stats(lw, flag) for _ in range(repeats)]
    _sync()
    said = f"lse_stats {what}: kernel {got.tolist()}, plain {want.tolist()}"
    if float(got[0]) != float(want[0]):
        raise AssertionError(f"{said}: the max differs")
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0,
                               msg=f"{said}: wtot")
    unequal = sum(not torch.equal(a, got) for a in again)
    if unequal:
        raise AssertionError(f"{said}: {unequal} of {repeats} calls differ "
                             "from the first")
    return float((got - want).abs().max()), float((got[1] - want[1]).abs() / want[1])


def check_lse_stats(w1, repeats=16):
    """K14 (one launch, the combine by the last CTA) against its plain
    version: on the path's weights (and ``repeats`` calls after it, each
    bit-equal to the first: the records are folded by CTA index), at n =
    2^24 - 3 (a ragged tail), on a view at a one-float offset (a scalar
    head before the first 16-byte boundary), on weights with a block of
    -inf, and with the flag 0 (no CTA writes a record and the ticket stays
    0) then a flagged call, which must be right.  Returns the largest
    absolute error of (m, wtot)."""
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.ops.population import current_stream

    dev = w1.device
    n = w1.shape[0]
    errs = [_check_lse(w1, f"n={n}", repeats)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(CHECK_SEED)
    ragged = 2 * torch.randn(n - 3, generator=gen, device=dev)
    offset = w1[1:]
    holes = w1.clone()
    holes[n // 3: n // 3 + 1_000_003] = -math.inf
    for what, lw in ((f"n={n - 3}", ragged), ("a view at a one-float offset", offset),
                     ("a block of -inf", holes)):
        errs.append(_check_lse(lw, what, 1))
    rec_m, rec_s, ticket = sr._LSE_SCRATCH[(dev, current_stream(dev).value)]
    before = (rec_m.clone(), rec_s.clone())
    off, on = (torch.full((), f, dtype=torch.int32, device=dev) for f in (0, 1))
    sr.logsumexp_stats(w1, off)
    _sync()
    if int(ticket) != 0 or not (torch.equal(rec_m, before[0])
                                and torch.equal(rec_s, before[1])):
        raise AssertionError("lse_stats: the flag 0 launch wrote a record or "
                             "moved the ticket")
    errs.append(_check_lse(w1, "flag 0 then 1", 0, on))
    err, rel = (max(e[i] for e in errs) for i in (0, 1))
    print(f"check lse_stats: n={n} and {repeats} calls bit-equal, n={n - 3}, a "
          "view at a one-float offset, a block of -inf and flag 0 then 1: max "
          f"equal, max |d wtot|/wtot={rel:.3g} (rtol 1e-12), max|d|={err:.3g}")
    return err


def _check_slots(st_k, st_p, what):
    """Pass 1's start slots against the plain version's: at most
    ``PASS1_SLACK`` differ, monotone, the first 0.  Returns the largest
    difference."""
    d_st = (st_k.long() - st_p.long()).abs()
    n_diff = int((d_st > 0).sum())
    if n_diff > PASS1_SLACK or not bool((st_k[1:] >= st_k[:-1]).all()) \
            or int(st_k[0]) != 0:
        raise AssertionError(f"pass1 {what}: {n_diff} start slots differ, or "
                             "they are not monotone from 0")
    return float(d_st.max())


def check_pass1(w1, n, repeats=64):
    """K15 (the single-pass scan) against ``resample_pass1_plain``: 64
    back-to-back calls on the path's weights, each equal to the first (a
    race in the look-back shows as an intermittent mismatch); the ragged
    sizes 1, 4,097 and 2^20 + 3; one heavy particle; all weights but one at
    -inf; the flag off and then on, on the same scratch.  Returns the
    largest slot difference."""
    from cpprob_tpu_torch.ops import stream_resample as sr

    dev = w1.device
    u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
    stats = sr.logsumexp_stats(w1)
    first = sr.resample_pass1(u0, w1, stats)
    err = _check_slots(first, sr.resample_pass1_plain(u0, w1, stats), f"n={n}")
    unequal = 0
    for _ in range(repeats):
        unequal += not torch.equal(sr.resample_pass1(u0, w1, stats), first)
    _sync()
    if unequal:
        raise AssertionError(f"pass1: {unequal} of {repeats} back-to-back calls "
                             "differ from the first")
    gen = torch.Generator(device=dev)
    gen.manual_seed(CHECK_SEED)
    heavy = torch.full((n,), -100.0, device=dev)
    heavy[12345] = 0.0
    lone = torch.full((n,), -math.inf, device=dev)
    lone[777] = 0.0
    cases = [(f"n={m}", 2 * torch.randn(m, generator=gen, device=dev))
             for m in (1, 4097, (1 << 20) + 3)]
    cases += [("one heavy particle", heavy), ("all but one at -inf", lone)]
    for what, lw in cases:
        lw_stats = sr.logsumexp_stats(lw)
        st = sr.resample_pass1(u0, lw, lw_stats)
        err = max(err, _check_slots(st, sr.resample_pass1_plain(u0, lw, lw_stats), what))
    off, on = (torch.full((), f, dtype=torch.int32, device=dev) for f in (0, 1))
    sr.resample_pass1(u0, w1, stats, off)
    err = max(err, _check_slots(sr.resample_pass1(u0, w1, stats, on),
                                sr.resample_pass1_plain(u0, w1, stats), "flag 0 then 1"))
    _sync()
    print(f"check pass1 n={n}: {repeats} back-to-back calls equal the first; the "
          f"ragged sizes, one heavy particle, all but one at -inf and the flag "
          f"off then on within {PASS1_SLACK} slots of the plain version, monotone "
          f"from 0 (max difference {err:.0f})")
    return err


def check_sass():
    """The machine code of the kernels this round redesigned, from the
    built libraries: ``tensor_core_kernel`` has ``HGMMA`` (wgmma) and no
    ``HMMA`` (mma.sync); ``pass1_scan_kernel``'s double-precision
    instructions a particle, held to ``PASS1_F64_OPS`` (its bound's count)
    within 20 %, and those of ``lse_stats_kernel``'s batch loop a weight,
    held to ``LSE_F64_OPS`` likewise; K7's spills and frame held to what
    the key in two registers gives it (:func:`_sincos_frame`).  Prints
    each one's registers and spills."""
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.util.sass import kernel_report

    tc = kernel_report("calibrate", "tensor_core_kernel")
    for f, r in tc.items():
        ops = r["opcodes"]
        print(f"SASS {f}: {r['registers']} registers, spills {r['spills']}, "
              f"HGMMA {ops.get('HGMMA', 0)}, HMMA {ops.get('HMMA', 0)}")
        if ops.get("HMMA", 0) or not ops.get("HGMMA", 0):
            raise AssertionError("tensor_core_kernel: not wgmma alone")
    if not tc:
        raise AssertionError("tensor_core_kernel: not in the library")
    dp_ops = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
    per = sr.PASS1_PER_THREAD
    p1 = kernel_report("stream_resample", "pass1_scan_kernel")
    if len(p1) != 1:
        raise AssertionError(f"pass1_scan_kernel: {len(p1)} functions")
    (f, r), = p1.items()
    dp = {o: c for o, c in r["opcodes"].items() if o in dp_ops}
    f64 = sum(dp.values()) / per
    print(f"SASS {f}: {r['registers']} registers, spills {r['spills']}, "
          f"double-precision instructions {dp}, {f64:.2f} a particle (the "
          f"bound counts {PASS1_F64_OPS})")
    if abs(f64 - PASS1_F64_OPS) > 0.2 * PASS1_F64_OPS:
        raise AssertionError("pass1_scan_kernel: PASS1_F64_OPS is stale")
    lse = kernel_report("stream_resample", "lse_stats_kernel")
    if len(lse) != 1:
        raise AssertionError(f"lse_stats_kernel: {len(lse)} functions")
    (f, r), = lse.items()
    dp_all = {o: c for o, c in r["opcodes"].items() if o in dp_ops}
    dp = {o: c for o, c in r["loop_opcodes"][0].items() if o in dp_ops}
    f64 = sum(dp.values()) / sr.LSE_PER_BATCH
    print(f"SASS {f}: {r['registers']} registers, spills {r['spills']}, stack "
          f"{r['stack']} B, loops {r['loops'][:3]}; double-precision "
          f"instructions {dp} in its batch loop ({dp_all} in all), {f64:.2f} a "
          f"weight (the bound counts {LSE_F64_OPS})")
    if abs(f64 - LSE_F64_OPS) > 0.2 * LSE_F64_OPS:
        raise AssertionError("lse_stats_kernel: LSE_F64_OPS is stale")
    _sincos_frame()
    check_chain_sass()


def check_chain_sass():
    """The chain chunk kernels (``hmm_chunk_kernel<K>`` for K = 2..8,
    ``hmm_chunk_kernel_k``, ``guided_chunk_kernel<K>``) and K13's tables
    kernel (``guided_tables_kernel<K>``): each instance's registers and
    local memory (stack frame, spill bytes, ``LDL``/``STL`` in its SASS),
    which must be none."""
    from cpprob_tpu_torch.util.sass import kernel_report

    for kernel in ("hmm_chunk_kernel", "guided_chunk_kernel", "guided_tables_kernel"):
        rep = kernel_report("fused_hmm", kernel)
        if len(rep) != (8 if kernel == "hmm_chunk_kernel" else 7):
            raise AssertionError(f"{kernel}: {len(rep)} instances in the library")
        for f, r in sorted(rep.items()):
            ops = r["opcodes"]
            local = ops.get("LDL", 0) + ops.get("STL", 0)
            print(f"SASS {f}: {r['registers']} registers, stack frame {r['stack']} B, "
                  f"spills {r['spills']}, {local} LDL/STL, {r['instructions']} "
                  f"instructions")
            if r["registers"] is None or r["stack"] is None:
                raise AssertionError(f"{f}: no ptxas report (the library was "
                                     f"built by another process)")
            if r["stack"] or r["spills"] != (0, 0) or local:
                raise AssertionError(f"{f} uses local memory")


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
    busy_share, span = _busy_share(dev)
    by_name = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + float(e["dur"]))
    total = sum(us for _, us in by_name.values())
    print(f"[{card}] profile of {sweeps} back-to-back sweeps: span "
          f"{span / 1e3 / sweeps:.4f} ms per sweep, device busy share "
          f"{busy_share:.4f}, {len(dev) / sweeps:.1f} device operations per "
          f"sweep; trace in {os.path.relpath(out, REPO)}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / total:7.2%}  {us / 1e3 / sweeps:8.4f} ms/sweep  "
              f"{n / sweeps:5.1f}/sweep  {name[:90]}")


def build_kernels(stages):
    """Builds every kernel library from the sources, one nvcc per source,
    all started together; prints the ptxas register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from cpprob_tpu_torch.ops import (
        _build,
        calibrate,
        fused_hmm,
        fused_lg,
        stream_resample,
    )

    mods = (fused_hmm, fused_lg, stream_resample, calibrate)
    with stages.stage("build", sync=True):
        with ThreadPoolExecutor(len(mods)) as pool:
            list(pool.map(lambda m: m._lib(), mods))
    print(f"build: {stages.totals['build']:.2f} s ({len(mods)} sources in parallel)")
    for name in ("fused_hmm", "fused_lg", "stream_resample", "calibrate"):
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Performance Loss")):
                print(f"  ptxas {name}:", line.strip())


def hmm_phases(card, stages):
    """The HMM main path: kernel checks, the multi-chunk sweep, 16 sweeps
    of the main path, timings and the profile.  Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models import hmm_log_evidence, simulate_observations
    from cpprob_tpu_torch.ops import fused_hmm
    from cpprob_tpu_torch.util.roofline import chain_chunk_bound, chain_init_bound

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
    with stages.stage("main_path", sync=True):
        launches, times, _ = run_path(
            run, obs, SWEEPS, (fused_hmm.LAUNCHES,), exact,
            f"main path n={MAIN_N} T={T} chunk={CHUNK} island_every="
            f"{ISLAND_EVERY} island_size={fused_hmm.ISLAND_SIZE}",
            epochs_each=False)
    n_chunks = -(-(T - 1) // CHUNK)
    _expect(launches, {"init": SWEEPS, "chunk": SWEEPS * n_chunks}, "main path")
    # the warm-up sweep's launch comes first
    sweep_counts = torch.stack(island_counts[-SWEEPS * n_chunks:])
    resamples = float(sweep_counts.mean())
    print(f"interior resamples per island per sweep, over the {SWEEPS} "
          f"main-path sweeps (mean): {resamples:.4f}")
    if not resamples > 0:
        raise AssertionError("the interior island trigger never fired")

    sweep_s = statistics.median(times)
    print(f"[{card}] median sweep {sweep_s * 1e3:.3f} ms, "
          f"{MAIN_N * T / sweep_s:.6g} particle-steps/s "
          f"(n={MAIN_N}, T={T}, {SWEEPS} sweeps, host clock, synced per sweep)")
    b2b_ms = time_ms(lambda: run(20_000, obs), SWEEPS)
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
            time_ms(lambda: fused_hmm.hmm_init(seed, obs[0], MAIN_N, spec), 10),
            time_ms(lambda: fused_hmm.hmm_init_plain(seed, obs[0], MAIN_N, spec), 2),
        ),
        "chunk": (
            time_ms(lambda: fused_hmm.hmm_chunk(seed, s0, w0, ys, ctrl, spec, **kw), 10),
            time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, s0, w0, ys, ctrl, spec, **kw), 2),
        ),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name} at n={MAIN_N}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    # K3: the same kernel without the island check, beside its plain version
    no_island_ms = time_ms(lambda: fused_hmm.hmm_chunk(
        seed, s0, w0, ys, ctrl, spec, t0=1, island_every=0), 10)
    no_island_plain = time_ms(lambda: fused_hmm.hmm_chunk_plain(
        seed, s0, w0, ys, ctrl, spec, t0=1, island_every=0), 1)
    print(f"[{card}] chunk at n={MAIN_N}, island_every=0 (K3): kernel "
          f"{no_island_ms:.4f} ms, plain {no_island_plain:.4f} ms")
    ROOFLINE_EXTRA.append(
        {"name": "hmm_chunk_kernel (K3, island_every=0)", "ms": no_island_ms,
         "launches": None, "plain_ms": no_island_plain,
         **chain_chunk_bound(MAIN_N, 3, int(n_valid))})
    with stages.stage("profile", sync=True):
        profile_sweeps(run, obs, card)

    src = "cpprob_tpu_torch/ops/csrc/fused_hmm.cu"
    return [
        {"name": "hmm_init_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:727",
         "launches": launches["init"], "max_abs_err": errs["init"],
         "ms": timing["init"][0], "plain_ms": timing["init"][1],
         **chain_init_bound(MAIN_N, 3)},
        {"name": "hmm_chunk_kernel", "route": "cuda", "source": src,
         "replaces": "cpprob_tpu/ops/pallas_hmm.py:245",
         "launches": launches["chunk"], "max_abs_err": errs["chunk"],
         "ms": timing["chunk"][0], "plain_ms": timing["chunk"][1],
         **chain_chunk_bound(MAIN_N, 3, int(n_valid), checks=1)},
    ]


def lg_phases(card, stages):
    """The continuous-state path: kernel checks at 2^24, 16 sweeps of the
    LG main path (chunk 8), 8 sweeps of the per-step path (2^20), timings
    and the profile.  Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        simulate_observations,
    )
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.util.roofline import (
        bound,
        normal_chunk_bound,
        normal_init_bound,
    )

    dev = torch.device("cuda")
    with stages.stage("lg_kernel_vs_plain", sync=True):
        errs = check_lg_kernels()
        errs["lg_init"] = max(check_lg_init(m) for m in (1000, (1 << 16) + 3, LG_N))
    obs = _lg_obs(dev)
    model = fused_lg.make_fused_lg_ssm()
    counters = (fused_lg.LAUNCHES, sr.LAUNCHES)
    run = build_smc_run(model, LG_N, ess_threshold=0.5,
                        resampling="systematic", chunk=LG_CHUNK)
    exact = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
    with stages.stage("lg_main_path", sync=True):
        launches, times, _ = run_path(
            run, obs, SWEEPS, counters, exact,
            f"LG main path n={LG_N} T={LG_T} chunk={LG_CHUNK}")
    # an epoch a chunk; the start and the close (K14) once a sweep
    n = SWEEPS * -(-(LG_T - 1) // LG_CHUNK)
    _expect(launches, {"chunk": n, "init": SWEEPS, "lse_stats": n + SWEEPS,
                       "pass1": n, "pass2": n}, "LG main path")
    run1 = build_smc_run(model, LG_STEP_N, ess_threshold=0.5,
                         resampling="systematic", chunk=1)
    with stages.stage("lg_step_path", sync=True):
        step_launches, step_times, _ = run_path(
            run1, obs, LG_STEP_SWEEPS, counters, exact,
            f"LG per-step path n={LG_STEP_N} T={LG_T} chunk=1")
    n = LG_STEP_SWEEPS * (LG_T - 1)
    _expect(step_launches, {"step_ctrl": n, "init": LG_STEP_SWEEPS,
                            "lse_stats": n + LG_STEP_SWEEPS, "pass1": n, "pass2": n},
            "LG per-step path")

    sweep_s = statistics.median(times)
    print(f"[{card}] LG median sweep {sweep_s * 1e3:.3f} ms, "
          f"{LG_N * LG_T / sweep_s:.6g} particle-steps/s (n={LG_N}, T={LG_T}, "
          f"chunk={LG_CHUNK}, {SWEEPS} sweeps, host clock, synced per sweep)")
    b2b_ms = time_ms(lambda: run(20_000, obs), SWEEPS)
    print(f"[{card}] LG back-to-back sweeps: {b2b_ms:.4f} ms each by CUDA "
          f"events, {LG_N * LG_T / (b2b_ms * 1e-3):.6g} particle-steps/s")
    step_s = statistics.median(step_times)
    step_b2b = time_ms(lambda: run1(21_000, obs), LG_STEP_SWEEPS)
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
    on = torch.ones((), dtype=torch.int32, device=dev)
    off = torch.zeros((), dtype=torch.int32, device=dev)
    timing = {
        "lg_chunk": (
            time_ms(lambda: fused_lg.lg_chunk(seed, x0, w0, ys[0], valid[0], t0=1), 10),
            time_ms(lambda: fused_lg.lg_chunk_plain(seed, x0, w0, ys[0], valid[0], t0=1), 2)),
        # the one-step launch as the per-step path runs it: with the step's
        # resample control, flag off (the weights read, the combine run)
        "lg_step_ctrl": (
            time_ms(lambda: fused_lg.lg_step_ctrl(seed, x0, w0, obs[1], 1, off,
                                                  0.5 * LG_N), 10),
            time_ms(lambda: fused_lg.lg_step_ctrl_plain(seed, x0, w0, obs[1], 1, off,
                                                        0.5 * LG_N), 2)),
        "lg_init": (
            time_ms(lambda: fused_lg.lg_init(seed, LG_N, obs[0], 0.5 * LG_N), 10),
            time_ms(lambda: fused_lg.lg_init_plain(seed, LG_N, obs[0], 0.5 * LG_N), 2)),
        "lse_stats": (
            time_ms(lambda: sr.logsumexp_stats(w1), 10),
            time_ms(lambda: sr.logsumexp_stats_plain(w1), 4)),
        "pass1": (
            time_ms(lambda: sr.resample_pass1(u0, w1, stats), 10),
            time_ms(lambda: sr.resample_pass1_plain(u0, w1, stats), 4)),
        "pass2": (
            time_ms(lambda: sr.resample_pass2(st, x1), 10),
            time_ms(lambda: sr.resample_pass2_plain(st, x1), 4)),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name} at n={LG_N}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")

    def epoch(flag):
        s = sr.logsumexp_stats(w1, flag)
        return sr.resample_pass2(sr.resample_pass1(u0, w1, s, flag), x1, flag)

    print(f"[{card}] epoch at n={LG_N} (K14 + K15 + K16): flagged "
          f"{time_ms(lambda: epoch(on), 10):.4f} ms, unflagged "
          f"{time_ms(lambda: epoch(off), 10):.4f} ms")
    # profiled twice, so the spread of the span and the busy share between
    # two profiles of the same sweeps shows beside them
    with stages.stage("lg_profile", sync=True):
        for _ in range(2):
            profile_sweeps(run, obs, card, trace="lg_sweep_trace.json")

    # one PyTorch call for the same function, where there is one (timed
    # here, never called by the port): K14's logsumexp, K15's float64 prefix
    # of the exponentiated weights, K16's expansion by counts
    e64 = torch.exp(w1.double() - stats[0])
    counts = torch.diff(st.long(), append=torch.full((1,), LG_N, device=dev))
    library = {
        "lse_stats": time_ms(lambda: torch.logsumexp(w1, 0), 10),
        "pass1": time_ms(lambda: torch.cumsum(e64, 0), 10),
        "pass2": time_ms(lambda: torch.repeat_interleave(
            x1, counts, output_size=LG_N), 10),
    }
    for name, ms in library.items():
        print(f"[{card}] {name} at n={LG_N}: one PyTorch call {ms:.4f} ms")
    n = LG_N
    bounds = {
        "lg_chunk": normal_chunk_bound(n, int(valid[0])),
        "lg_step_ctrl": normal_chunk_bound(n, 1),
        "lg_init": normal_init_bound(n),
        # K14 reads the weights, with LSE_F64_OPS double-precision
        # instructions a weight (the float64 exp and the sum, counted from
        # its batch loop's SASS by check_sass); K15
        # reads them and writes int32 start slots, with PASS1_F64_OPS
        # double-precision instructions a particle (the float64 exp, the
        # prefix adds and the slot arithmetic, counted from its SASS by
        # check_sass); K16 reads the start slots and the values and writes
        # the values, with the owner scatter, the max-scan and the gather
        # per slot (~3 ops)
        "lse_stats": bound(4 * n, f64_ops=LSE_F64_OPS * n, library_ms=library["lse_stats"]),
        "pass1": bound(8 * n, f64_ops=PASS1_F64_OPS * n, library_ms=library["pass1"]),
        "pass2": bound(12 * n, 3 * n, library_ms=library["pass2"]),
    }

    def line(name, key, replaces, src, n_launch):
        return {"name": name, "route": "cuda",
                "source": f"cpprob_tpu_torch/ops/csrc/{src}",
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": errs[key], "ms": timing[key][0],
                "plain_ms": timing[key][1], **bounds[key]}

    return [
        line("lg_chunk_kernel", "lg_chunk", "cpprob_tpu/ops/pallas_hmm.py:808",
             "fused_lg.cu", launches["chunk"]),
        line("lg_chunk_kernel (n_steps=1, lg_step_ctrl)", "lg_step_ctrl",
             "cpprob_tpu/ops/pallas_hmm.py:669", "fused_lg.cu",
             step_launches["step_ctrl"]),
        line("lg_init_kernel", "lg_init", "none (the JAX package's start is plain XLA)",
             "fused_lg.cu", launches["init"]),
        line("lse_stats_kernel", "lse_stats",
             "cpprob_tpu/ops/pallas_resample.py:727", "stream_resample.cu",
             launches["lse_stats"]),
        line("pass1_scan_kernel", "pass1",
             "cpprob_tpu/ops/pallas_resample.py:113", "stream_resample.cu",
             launches["pass1"]),
        line("pass2_tile_kernel (scatter)", "pass2",
             "cpprob_tpu/ops/pallas_resample.py:645",
             "stream_resample.cu", launches["pass2"]),
    ]


# ---------------------------------------------------------------------------
# the kernel-from-spec family: K8/K9 (spec chains), K4/K5 (per-step HMM
# launches), K10/K11 (user physics, CUDA generated from the physics)

TRANS5 = [[0.50, 0.20, 0.10, 0.10, 0.10],
          [0.05, 0.60, 0.20, 0.10, 0.05],
          [0.10, 0.10, 0.40, 0.30, 0.10],
          [0.20, 0.05, 0.05, 0.50, 0.20],
          [0.10, 0.10, 0.10, 0.10, 0.60]]
MEANS5 = [-2.0, -1.0, 0.0, 1.0, 2.0]
STDS5 = [0.5, 1.0, 0.7, 1.2, 0.9]
INIT5 = [0.3, 0.1, 0.2, 0.2, 0.2]
SPEC_N = 1 << 24          # paths 1 and 2 (examples/kernel_bench.py --n 24)
SPEC_CHUNK = 8
SPEC_ISLAND_CHUNK = 16
BIGK_N = 1 << 20          # path 3 (tests/test_tpu_hw.py:42-66)
BIGK_T = 12
BIGK_CHUNK = 4
STEP_N = 1 << 20          # path 4
USER_N = 1 << 24          # path 5
VEC_N = 1 << 20           # path 6
VEC_CHUNK = 4
SHORT_SWEEPS = 8
HALF_LOG_2PI = 0.9189385332046727
# the 2-D linear-Gaussian model of tests/test_vector_ssm.py:19-60
A2 = [[0.9, 0.1], [0.0, 0.8]]
H2 = [1.0, 1.0]


def lg_step_elem(x, y, eps):
    """The linear-Gaussian physics of examples/kernel_bench.py:150-153."""
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - HALF_LOG_2PI


def lg2d_step_elem(x0, x1, y, e0, e1):
    """The 2-D linear-Gaussian physics of tests/test_tpu_hw.py:176-181."""
    n0 = 0.9 * x0 + 0.1 * x1 + e0
    n1 = 0.8 * x1 + e1
    d = y - (n0 + n1)
    return n0, n1, -0.5 * d * d - HALF_LOG_2PI


def _chain(K):
    """The 5-state chain of examples/kernel_bench.py:31-42, or the K-state
    recipe of tests/test_tpu_hw.py:52-59 (Dirichlet rows from
    default_rng(K), evenly spaced means and stds, uniform start)."""
    import numpy as np

    if K == 5:
        return (np.array(TRANS5), np.array(MEANS5), np.array(STDS5),
                np.array(INIT5))
    rng = np.random.default_rng(K)
    return (rng.dirichlet(np.ones(K), size=K), np.linspace(-3.0, 3.0, K),
            np.linspace(0.5, 1.6, K), np.full(K, 1.0 / K))


def _chain_obs(K, T, seed):
    """Observations simulated from the chain with default_rng(seed), as
    kernel_bench.py:112-118 and test_tpu_hw.py:31-39 make them."""
    import numpy as np

    trans, means, stds, init = _chain(K)
    rng = np.random.default_rng(seed)
    z = rng.choice(K, p=init)
    ys = []
    for _ in range(T):
        ys.append(means[z] + stds[z] * rng.standard_normal())
        z = rng.choice(K, p=trans[z])
    return np.array(ys, np.float32)


def _lg2d_obs(T=16, seed=4):
    import numpy as np

    A, H = np.array(A2), np.array(H2)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2)
    ys = []
    for t in range(T):
        if t > 0:
            x = A @ x + rng.standard_normal(2)
        ys.append(H @ x + rng.standard_normal())
    return np.array(ys, np.float32)


def kalman_2d_loglik(ys):
    """Exact log p(y_{1:T}) of the 2-D model (float64 numpy; the oracle of
    tests/test_vector_ssm.py:44-60)."""
    import numpy as np

    A, H = np.array(A2), np.array(H2)
    m, P, Q, ll = np.zeros(2), np.eye(2), np.eye(2), 0.0
    for t, y in enumerate(np.asarray(ys, np.float64)):
        if t > 0:
            m = A @ m
            P = A @ P @ A.T + Q
        S = H @ P @ H + 1.0
        r = y - H @ m
        ll += -0.5 * r * r / S - 0.5 * np.log(2 * np.pi * S)
        K = P @ H / S
        m = m + K * r
        P = P - np.outer(K, H @ P)
    return float(ll)


def lg2d_model(device):
    """The 2-D linear-Gaussian model with batched hooks, its tables on
    ``device`` (a hook copies nothing from the host)."""
    from cpprob_tpu_torch import StateSpaceModel

    a_t = torch.tensor(A2, device=device).T.contiguous()
    h = torch.tensor(H2, device=device)

    def randn(key, shape):
        return torch.randn(shape, generator=key, device=key.device)

    def obs_logpdf(s, y, t):
        d = y - s @ h
        return -0.5 * d * d - HALF_LOG_2PI

    return StateSpaceModel(
        init_sample=lambda key: randn(key, (2,)),
        init_logpdf=lambda s: torch.sum(-0.5 * s * s - HALF_LOG_2PI),
        step_sample=lambda key, s, t: s @ a_t + randn(key, (2,)),
        step_logpdf=lambda ns, s, t: torch.sum(-0.5 * (ns - s @ a_t) ** 2
                                               - HALF_LOG_2PI),
        obs_logpdf=obs_logpdf,
        init_sample_batch=lambda key, n: randn(key, (n, 2)),
        step_sample_batch=lambda key, s, t: s @ a_t + randn(key, s.shape),
        obs_logpdf_batch=obs_logpdf,
        vector_state_dim=2,
    )


def _compare_chunk(out_k, out_p, K, n, what, want):
    """Kernel against plain chunk outputs: interior resample counts equal
    (and as ``want`` says: None, a count, "fires", or "splits": some islands
    but not all); a fired check may
    place up to K-1 slots of its island differently (its ticks come from
    sums in another order); every other state equal and log_w within 1e-5
    relative.  Returns the max |dlog_w| elsewhere."""
    from cpprob_tpu_torch.ops.fused_hmm import ISLAND_SIZE

    ok, ow, orec = out_k
    pk, pw, prec = out_p
    counts = orec[:, -1]
    if not torch.equal(counts, prec[:, -1]):
        raise AssertionError(f"{what}: interior resample counts differ")
    fired = float(counts.mean())
    if want == "fires" and not fired > 0:
        raise AssertionError(f"{what}: the island check never fired")
    if want == "splits" and not 0.0 < fired < 1.0:
        raise AssertionError(f"{what}: the islands did not split")
    if isinstance(want, float) and fired != want:
        raise AssertionError(f"{what}: {fired} resamples per island, "
                             f"expected {want}")
    bad = (ok != pk) | ~torch.isclose(ow, pw, rtol=1e-5, atol=0)
    per_isl = bad.view(n // ISLAND_SIZE, ISLAND_SIZE).sum(1)
    if bool((per_isl > (K - 1) * counts).any()):
        raise AssertionError(f"{what}: {int(bad.sum())} particles differ")
    _close_stats(orec, prec, n, what)
    err = float((ow - pw).abs()[~bad].max())
    print(f"check {what}: {int(bad.sum())} slots differ, mean resamples/"
          f"island={fired:.4f}, max|dlog_w|={err:.3g}")
    return err


def _check_init(seed, y0, n, spec, what):
    """The init kernel against its plain version (the initial uniform of
    particle g is word g & 3 of Philox at (g >> 2, 0, 0, 0) on both sides):
    states equal bit for bit, log_w within 1e-5 relative, records (from the
    kernel's state counts) close; at ``n`` and at a ragged 4,099 (a quad cut
    short).  Returns (states, log_w, max |dlog_w|) of the kernel at n."""
    from cpprob_tpu_torch.ops.fused_hmm import hmm_init, hmm_init_plain

    err = 0.0
    for size in (4099, n):
        s_k, w_k, rec_k = hmm_init(seed, y0, size, spec)
        s_p, w_p, rec_p = hmm_init_plain(seed, y0, size, spec)
        _sync()
        if not torch.equal(s_k, s_p):
            raise AssertionError(f"{what} n={size}: states differ")
        torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=0,
                                   msg=f"{what} n={size}: log_w")
        _close_stats(rec_k, rec_p, size, f"{what} n={size}")
        err = max(err, float((w_k - w_p).abs().max()))
        print(f"check {what} (at n={size}): states equal, max|dlog_w|="
              f"{float((w_k - w_p).abs().max()):.3g}")
    return s_k, w_k, err


def check_spec_kernels(n=SPEC_N, n_big=BIGK_N, seed=CHECK_SEED):
    """K9 and K8 against their plain versions on the card: K = 5 at path 1
    and 2's shapes (n, 8- and 16-slot chunks), K = 12 and 32 at path 3's
    (n_big, 4-slot chunks), K = 1 once; the flag off and on, n_valid short,
    the island check forced (2.0), at 0.5 and never firing (0.0).  States
    equal, log_w within 1e-5 relative.  Returns the largest |dlog_w| of
    each kernel; raises on any disagreement."""
    from cpprob_tpu_torch.inference.smc import _chunk_observations
    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.ops.fused_hmm import hmm_chunk, hmm_chunk_plain

    dev = torch.device("cuda")
    errs = {"spec_init": 0.0, "spec_chunk": 0.0}
    for K, size in ((5, n), (12, n_big), (32, n_big), (1, n_big)):
        spec = spec_from_numpy(*_chain(K)) if K > 1 else spec_from_numpy(
            [[1.0]], [0.3], [1.2], [1.0])
        T = 16 if K == 5 else BIGK_T
        obs = torch.as_tensor(_chain_obs(max(K, 5), T, K if K > 1 else 0),
                              device=dev)
        s_k, w_k, err = _check_init(seed, obs[0], size, spec,
                                    f"spec init K={K} n={size}")
        errs["spec_init"] = max(errs["spec_init"], err)

        chunk = SPEC_CHUNK if K == 5 else BIGK_CHUNK
        ys, valid = _chunk_observations(obs, chunk)
        ys0 = ys[0].contiguous()
        ticks = [size * (k + 1) // K for k in range(K - 1)]
        cases = []
        for flag in (0, 1):
            ctrl = torch.tensor([flag, *ticks, chunk], dtype=torch.int32, device=dev)
            cases.append((ys0, ctrl, 0, 0.5, None))
        ctrl = torch.tensor([0, *ticks, chunk - 1], dtype=torch.int32, device=dev)
        cases.append((ys0, ctrl, 0, 0.5, None))
        if K == 5:      # path 2's launch: 16 slots, 15 valid, island every 8
            ys16, v16 = _chunk_observations(obs, SPEC_ISLAND_CHUNK)
            isl_ys, isl_every = ys16[0].contiguous(), ISLAND_EVERY
            isl_valid = int(v16[0])
        else:           # a check after every second step of path 3's chunk
            isl_ys, isl_every, isl_valid = ys0, 2, chunk
        for flag in (0, 1):
            ctrl = torch.tensor([flag, *ticks, isl_valid], dtype=torch.int32,
                                device=dev)
            cases += [(isl_ys, ctrl, isl_every, 2.0, "fires"),
                      (isl_ys, ctrl, isl_every, 0.5, None),
                      (isl_ys, ctrl, isl_every, 0.0, 0.0)]
        cases = [(1, *c) for c in cases]
        # the first case from t0 = 2, 3, 4 as well (2, 3, 0 mod 4)
        cases += [(t0, *cases[0][1:]) for t0 in (2, 3, 4)]
        for t0, ys_c, ctrl, every, thresh, want in (cases[:1] if K == 1 else cases):
            kw = dict(t0=t0, island_every=every, island_thresh=thresh)
            out_k = hmm_chunk(seed, s_k, w_k, ys_c, ctrl, spec, **kw)
            out_p = hmm_chunk_plain(seed, s_k, w_k, ys_c, ctrl, spec, **kw)
            _sync()
            what = (f"spec chunk K={K} n={size} t0={t0} flag={int(ctrl[0])} n_valid="
                    f"{int(ctrl[-1])}/{ys_c.shape[0]} island_every={every} "
                    f"thresh={thresh}")
            errs["spec_chunk"] = max(errs["spec_chunk"], _compare_chunk(
                out_k, out_p, K, size, what, want))
            del out_k, out_p
        if K in (5, 12):
            # the register instance (K8) and the run-time-K one
            ctrl = torch.tensor([1, *ticks, chunk - 1], dtype=torch.int32, device=dev)
            check_chunk_steps(
                lambda s, w, y, c, t0, every, thresh: hmm_chunk(
                    seed, s, w, y, c, spec, t0=t0, island_every=every,
                    island_thresh=thresh),
                s_k, w_k, ys0, ctrl, K, f"spec chunk K={K} n={size}",
                every=3 if K == 5 else 2)
    return errs


def check_step_kernels(n=STEP_N, seed=CHECK_SEED):
    """K4 and K5, the one-step launches behind the HMM's per-step hooks,
    against ``hmm_chunk_plain`` at n_steps = 1 on the card (the same
    absolute step t0 = 5): K4 with the flag off and on, K5 with flag 0.
    States equal, log_w within 1e-5 relative (the same float32 operations
    in the same order: equal in practice).  Returns the largest |dlog_w|."""
    from cpprob_tpu_torch.ops import fused_hmm

    dev = torch.device("cuda")
    spec = _spec()
    model = fused_hmm.make_fused_hmm_ssm(spec=spec)
    obs = _observations(dev)
    s0, w0, _ = fused_hmm.hmm_init(seed, obs[0], n, spec)
    ticks = torch.tensor([n // 3, 2 * n // 3], dtype=torch.int32, device=dev)
    errs = {"step_exchange": 0.0, "step_ess": 0.0}
    for flag in (0, 1):
        f = torch.tensor(flag, dtype=torch.int32, device=dev)
        s_k, w_k, ess_k, cat_k, lme_k = model.fused_step_exchange_batch(
            seed, s0, w0, obs[5], 5, f, ticks)
        ctrl = torch.tensor([flag, n // 3, 2 * n // 3, 1], dtype=torch.int32,
                            device=dev)
        s_p, w_p, rec_p = fused_hmm.hmm_chunk_plain(
            seed, s0, w0, obs[5].reshape(1), ctrl, spec, t0=5)
        _sync()
        if not torch.equal(s_k, s_p):
            raise AssertionError(f"K4 flag={flag}: states differ")
        torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=0,
                                   msg=f"K4 flag={flag}: log_w")
        ess_p, cat_p, lme_p = fused_hmm.stats_from_partials(rec_p, n)
        torch.testing.assert_close(ess_k, ess_p, rtol=1e-4, atol=0)
        torch.testing.assert_close(cat_k, cat_p, rtol=0, atol=1e-4)
        torch.testing.assert_close(lme_k, lme_p, rtol=1e-4, atol=0)
        err = float((w_k - w_p).abs().max())
        errs["step_exchange"] = max(errs["step_exchange"], err)
        print(f"check K4 (one-step exchange launch) n={n} flag={flag}: states "
              f"equal, max|dlog_w|={err:.3g}, bit-equal={torch.equal(w_k, w_p)}")
    s_k, w_k, ess_k = model.fused_step_ess_batch(seed, s0, w0, obs[5], 5)
    ctrl = torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=dev)
    s_p, w_p, rec_p = fused_hmm.hmm_chunk_plain(
        seed, s0, w0, obs[5].reshape(1), ctrl, spec, t0=5)
    _sync()
    if not torch.equal(s_k, s_p):
        raise AssertionError("K5: states differ")
    torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=0, msg="K5: log_w")
    torch.testing.assert_close(ess_k, fused_hmm.stats_from_partials(rec_p, n)[0],
                               rtol=1e-4, atol=0)
    errs["step_ess"] = float((w_k - w_p).abs().max())
    print(f"check K5 (one-step launch with ESS) n={n}: states equal, "
          f"max|dlog_w|={errs['step_ess']:.3g}, bit-equal={torch.equal(w_k, w_p)}")
    return errs


def growth_step_elem(x, y, eps):
    """A non-linear physics (sin, tanh, minimum)."""
    nx = 0.7 * x + 2.0 * elem.sin(x) + 0.5 * eps
    d = (y - elem.minimum(elem.tanh(nx), 2.0)) / 0.6
    return nx, -0.5 * d * d - HALF_LOG_2PI


def check_user_kernels(n=USER_N, n_vec=VEC_N, seed=CHECK_SEED):
    """The user-physics kernels (CUDA generated from the step_elem) against
    their plain versions on the card: K10 with the LG physics (t0 1, 2 and
    9; n_valid 8 and 7) and its one-step launch, within 1e-5 (relative, and
    absolute on the unit scale of the states: CUDA's precise functions and
    torch's may differ in the last bit); K10 with the LG physics against K7
    (lg_chunk) on the same draws, within 1e-5; K10 with a non-linear physics
    (sin, tanh) within 1e-3 (x' = 0.7x + 2 sin x can grow a last-bit
    difference ~2.7-fold a step over 8 steps); K11 (D = 2, t0 1 and 2)
    within 1e-5.  Returns the largest |dlog_w| of each and the kernel
    objects."""
    from cpprob_tpu_torch.ops import fused_lg, user_chunk

    dev = torch.device("cuda")
    obs = _lg_obs(dev)
    x0, w0 = _lg_population(n, seed, obs)
    ys, _ = _lg_chunks(obs)
    errs = {"scalar": 0.0, "vector": 0.0, "scalar_vs_lg": 0.0}
    eight = torch.full((), LG_CHUNK, dtype=torch.int32, device=dev)
    seven = torch.full((), LG_CHUNK - 1, dtype=torch.int32, device=dev)
    lg_k = user_chunk.UserKernel(lg_step_elem, 1)
    growth_k = user_chunk.UserKernel(growth_step_elem, 1)
    for (t0, ys_c), n_valid in itertools.product(
            ((1, ys[0]), (2, ys[0]), (9, ys[1])), (eight, seven)):
        out_p = user_chunk.user_chunk_plain(lg_step_elem, 1, seed, x0, w0, ys_c,
                                            n_valid, t0=t0)
        out_7 = fused_lg.lg_chunk(seed, x0, w0, ys_c, n_valid, t0=t0)
        out_k = lg_k.chunk(seed, x0, w0, ys_c, n_valid, t0=t0)
        _sync()
        what = f"K10 (LG physics) n={n} t0={t0} n_valid={int(n_valid)}/{LG_CHUNK}"
        for a, b, tag in ((out_k, out_p, "plain"), (out_k, out_7, "K7")):
            torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5,
                                       msg=f"{what} vs {tag}: states")
            torch.testing.assert_close(a[1], b[1], rtol=1e-5, atol=1e-5,
                                       msg=f"{what} vs {tag}: log_w")
            _close_stats(a[2], b[2], n, f"{what} vs {tag}")
        e_p = float((out_k[1] - out_p[1]).abs().max())
        e_7 = float((out_k[1] - out_7[1]).abs().max())
        errs["scalar"] = max(errs["scalar"], e_p)
        errs["scalar_vs_lg"] = max(errs["scalar_vs_lg"], e_7)
        print(f"check {what}: max|dlog_w| vs plain {e_p:.3g} (states "
              f"{float((out_k[0] - out_p[0]).abs().max()):.3g}), vs K7 "
              f"{e_7:.3g}, bit-equal to K7: {torch.equal(out_k[0], out_7[0]) and torch.equal(out_k[1], out_7[1])}")
        del out_k, out_p, out_7
    out_k = lg_k.chunk(seed, x0, w0, obs[1].reshape(1), t0=1, step=True)
    out_p = user_chunk.user_chunk_plain(lg_step_elem, 1, seed, x0, w0,
                                        obs[1].reshape(1), t0=1)
    _sync()
    torch.testing.assert_close(out_k[1], out_p[1], rtol=1e-5, atol=1e-5,
                               msg="K10 one-step launch: log_w")
    out_k = growth_k.chunk(seed, x0, w0, ys[0], eight, t0=1)
    out_p = user_chunk.user_chunk_plain(growth_step_elem, 1, seed, x0, w0,
                                        ys[0], eight, t0=1)
    _sync()
    torch.testing.assert_close(out_k[0], out_p[0], rtol=1e-3, atol=1e-3,
                               msg="K10 (growth physics): states")
    torch.testing.assert_close(out_k[1], out_p[1], rtol=1e-3, atol=1e-3,
                               msg="K10 (growth physics): log_w")
    print(f"check K10 (growth physics) n={n}: max|dx|="
          f"{float((out_k[0] - out_p[0]).abs().max()):.3g} max|dlog_w|="
          f"{float((out_k[1] - out_p[1]).abs().max()):.3g}")
    del out_k, out_p, x0, w0

    vobs = torch.as_tensor(_lg2d_obs(), device=dev)
    vys, _ = _chunk_obs(vobs, VEC_CHUNK)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = lg2d_model(dev)
    xv = model.init_sample_batch(gen, n_vec)
    wv = model.obs_logpdf_batch(xv, vobs[0], 0)
    vec_k = user_chunk.UserKernel(lg2d_step_elem, 2)
    four = torch.full((), VEC_CHUNK, dtype=torch.int32, device=dev)
    for t0 in (1, 2):
        out_k = vec_k.chunk(seed, xv, wv, vys[0], four, t0=t0)
        out_p = user_chunk.user_chunk_plain(lg2d_step_elem, 2, seed, xv, wv,
                                            vys[0], four, t0=t0)
        _sync()
        what = f"K11 (D=2) n={n_vec} t0={t0}"
        torch.testing.assert_close(out_k[0], out_p[0], rtol=1e-5, atol=1e-5,
                                   msg=f"{what}: states")
        torch.testing.assert_close(out_k[1], out_p[1], rtol=1e-5, atol=1e-5,
                                   msg=f"{what}: log_w")
        _close_stats(out_k[2], out_p[2], n_vec, what)
        err = float((out_k[1] - out_p[1]).abs().max())
        errs["vector"] = max(errs["vector"], err)
        print(f"check {what}: max|dx|={float((out_k[0] - out_p[0]).abs().max()):.3g} "
              f"max|dlog_w|={err:.3g}")
    return errs, (lg_k, growth_k, vec_k)


def _sincos_frame():
    """The stack frame of ``lg_init_kernel``, whose one frame (and its
    LDL/STL) is the slow-path argument reduction of the precise ``sincosf``
    (for |x| > 105615, never a Box-Muller angle), which every Box-Muller
    kernel carries; with K7's report, which must keep no more than the 44 B
    of spill stores and loads and the 80 B frame that ptxas gives it with
    the key in two registers (the spills sit around that slow path, and
    keep K7 at 80 registers, three CTAs an SM: K7 times as with the key by
    value).  Returns the frame's bytes."""
    from cpprob_tpu_torch.ops.fused_lg import K7_SYMBOL
    from cpprob_tpu_torch.util.sass import kernel_report

    (fi, ri), = kernel_report("fused_lg", "lg_init_kernel").items()
    (f7, r7), = kernel_report("fused_lg", K7_SYMBOL).items()
    for f, r in ((fi, ri), (f7, r7)):
        local = r["opcodes"].get("LDL", 0) + r["opcodes"].get("STL", 0)
        print(f"SASS {f}: {r['registers']} registers, stack frame {r['stack']} B, "
              f"spills {r['spills']}, {local} LDL/STL")
    if ri["spills"] != (0, 0) or ri["stack"] is None:
        raise AssertionError(f"{fi}: spills {ri['spills']}, stack {ri['stack']}")
    if (r7["spills"] is None or r7["spills"][0] > 44 or r7["spills"][1] > 44
            or r7["stack"] > 80):
        raise AssertionError(f"{f7}: spills {r7['spills']} and stack {r7['stack']} B "
                             "beyond 44/44 B and 80 B")
    return ri["stack"]


def check_user_sass(kernels):
    """The generated user libraries' machine code: each user_chunk_kernel's
    registers, spills and local memory.  None may spill, and none may keep
    a stack frame larger than the precise ``sincosf``'s
    (:func:`_sincos_frame`), which ``elem.sin``/``cos`` share."""
    from cpprob_tpu_torch.util.sass import kernel_report

    frame = _sincos_frame()
    for k in kernels:
        rep = kernel_report(k.library, "user_chunk_kernel")
        if len(rep) != 1:
            raise AssertionError(f"{k.library}: {len(rep)} user_chunk_kernel functions")
        for f, r in sorted(rep.items()):
            ops = r["opcodes"]
            local = ops.get("LDL", 0) + ops.get("STL", 0)
            print(f"SASS {k.library} {f}: {r['registers']} registers, stack frame "
                  f"{r['stack']} B, spills {r['spills']}, {local} LDL/STL, "
                  f"{r['instructions']} instructions, {ops.get('MUFU', 0)} MUFU, "
                  f"loops {r['loops'][:2]}")
            if r["registers"] is None or r["stack"] is None:
                raise AssertionError(f"{f}: no ptxas report")
            if r["spills"] != (0, 0) or r["stack"] > frame:
                raise AssertionError(f"{f} uses local memory beyond the sincosf frame")


def _chunk_obs(obs, chunk):
    from cpprob_tpu_torch.inference.smc import _chunk_observations

    ys, valid = _chunk_observations(obs, chunk)
    return [y.contiguous() for y in ys], valid


def run_path(run, obs, sweeps, counters, exact, what, *, epochs_each=True):
    """``sweeps`` sweeps of ``run`` under sync-debug "error", the launch
    counters set to 0 just before and read just after; logZ against
    ``exact`` within 4 SE + 0.02 and, with ``epochs_each``, at least one
    resample in every sweep.  Returns (launches, times, results)."""
    import numpy as np

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
    launches = {name: v for c in counters for name, v in c.items() if v}
    zs = torch.stack([r.log_evidence for r in results]).cpu().numpy()
    epochs = torch.stack([r.resampled for r in results]).sum(1).cpu().numpy()
    if not np.isfinite(zs).all():
        raise AssertionError(f"{what}: non-finite logZ {zs}")
    mean, se = float(zs.mean()), float(zs.std(ddof=1) / math.sqrt(sweeps))
    tol = 4 * se + 0.02
    print(f"{what}: mean logZ={mean:.6f} SE={se:.3g} exact={exact:.6f} "
          f"tol={tol:.4f}; resamples per sweep {epochs.tolist()}; launches "
          f"{launches}; median sweep {statistics.median(times) * 1e3:.3f} ms "
          "(host clock, synced)")
    if abs(mean - exact) > tol:
        raise AssertionError(f"{what}: logZ outside 4 SE + 0.02 of exact")
    if epochs_each and not (epochs >= 1).all():
        raise AssertionError(f"{what}: a sweep never resampled")
    return launches, times, results


def _expect(launches, want, what):
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, expected {want}")


def spec_phases(card, stages):
    """The kernel-from-spec family: kernel checks (K9, K8, K4, K5), paths 1
    to 4, timings and the profile of path 1.  Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run, smc
    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.models import hmm_log_evidence, simulate_observations
    from cpprob_tpu_torch.ops import fused_hmm
    from cpprob_tpu_torch.ops.fused_ssm import (
        discrete_hmm_log_evidence,
        make_fused_discrete_ssm,
    )
    from cpprob_tpu_torch.util.roofline import chain_chunk_bound, chain_init_bound

    dev = torch.device("cuda")
    with stages.stage("spec_kernel_vs_plain", sync=True):
        errs = check_spec_kernels()
        errs.update(check_step_kernels())
    counters = (fused_hmm.LAUNCHES,)
    launches = {}

    # paths 1 and 2: kernel_bench's 5-state chain at 2^24
    ys5 = _chain_obs(5, T, 0)
    exact5 = discrete_hmm_log_evidence(*_chain(5), ys5)
    obs5 = torch.as_tensor(ys5, device=dev)
    m5 = make_fused_discrete_ssm(*_chain(5))
    run1 = build_smc_run(m5, SPEC_N, chunk=SPEC_CHUNK)
    with stages.stage("spec_path1", sync=True):
        got, times1, _ = run_path(run1, obs5, SWEEPS, counters, exact5,
                                  f"path 1: spec chain K=5 n={SPEC_N} T={T} chunk={SPEC_CHUNK}")
    n_ch = -(-(T - 1) // SPEC_CHUNK)
    _expect(got, {"init": SWEEPS, "chunk": SWEEPS * n_ch}, "path 1")
    launches["init"] = got["init"]
    launches["chunk"] = got["chunk"]
    island_counts = []
    run2 = build_smc_run(make_fused_discrete_ssm(
        *_chain(5), island_every=ISLAND_EVERY, island_counts=island_counts),
        SPEC_N, chunk=SPEC_ISLAND_CHUNK)
    with stages.stage("spec_path2", sync=True):
        island_counts.clear()
        got, _, _ = run_path(run2, obs5, SWEEPS, counters, exact5,
                             f"path 2: spec chain K=5 n={SPEC_N} chunk={SPEC_ISLAND_CHUNK} "
                             f"island_every={ISLAND_EVERY}", epochs_each=False)
    _expect(got, {"init": SWEEPS, "chunk": SWEEPS}, "path 2")
    interior = float(torch.stack(island_counts[-SWEEPS:]).mean())
    print(f"path 2: interior resamples per island per sweep (mean) {interior:.4f}")
    if not interior > 0:
        raise AssertionError("path 2: the interior island check never fired")
    launches["chunk"] += got["chunk"]
    launches["init"] += got["init"]

    # path 3: K = 12 and 32 at 2^20
    runs3 = {}
    for K in (12, 32):
        ysk = _chain_obs(K, BIGK_T, K)
        runk = build_smc_run(make_fused_discrete_ssm(*_chain(K)), BIGK_N,
                             chunk=BIGK_CHUNK)
        runs3[K] = (runk, torch.as_tensor(ysk, device=dev))
        with stages.stage(f"spec_path3_K{K}", sync=True):
            got, _, _ = run_path(runk, torch.as_tensor(ysk, device=dev),
                                 SHORT_SWEEPS, counters,
                                 discrete_hmm_log_evidence(*_chain(K), ysk),
                                 f"path 3: K={K} n={BIGK_N} T={BIGK_T} chunk={BIGK_CHUNK}")
        _expect(got, {"init": SHORT_SWEEPS,
                      "chunk": SHORT_SWEEPS * -(-(BIGK_T - 1) // BIGK_CHUNK)},
                f"path 3 K={K}")
        launches["init"] += got["init"]
        launches["chunk"] += got["chunk"]

    # path 4: the HMM's per-step launches
    obs = _observations(dev)
    exact = hmm_log_evidence(simulate_observations(T, 0))
    hmm = fused_hmm.make_fused_hmm_ssm(spec=_spec())
    run4 = build_smc_run(hmm, STEP_N)
    with stages.stage("step_path_exchange", sync=True):
        got, times4, _ = run_path(run4, obs, SHORT_SWEEPS, counters, exact,
                                  f"path 4: HMM chunk=1 (K4) n={STEP_N}")
    _expect(got, {"step_exchange": SHORT_SWEEPS * (T - 1)}, "path 4 (K4)")
    launches["step_exchange"] = got["step_exchange"]
    run5 = lambda seed, o: smc(hmm, o, STEP_N, seed)
    with stages.stage("step_path_smc", sync=True):
        got, times5, res5 = run_path(run5, obs, SHORT_SWEEPS, counters, exact,
                                     f"path 4: HMM smc() with history (K5) n={STEP_N}")
    _expect(got, {"step_ess": SHORT_SWEEPS * (T - 1)}, "path 4 (K5)")
    if res5[0].states.shape != (T, STEP_N):
        raise AssertionError("smc() history of the wrong shape")
    launches["step_ess"] = got["step_ess"]

    # timings at the paths' shapes
    seed = CHECK_SEED
    spec5 = spec_from_numpy(*_chain(5))
    s0, w0, _ = fused_hmm.hmm_init(seed, obs5[0], SPEC_N, spec5)
    ys, valid = _chunk_obs(obs5, SPEC_CHUNK)
    ctrl = torch.tensor([0, *[SPEC_N * (k + 1) // 5 for k in range(4)], int(valid[0])],
                        dtype=torch.int32, device=dev)
    # the one-step launches as the hooks make them (the hooks' ctrl and
    # statistics glue are not timed): K4 with the flag and ticks live, K5
    # with flag 0
    spec3 = _spec()
    sh, wh, _ = fused_hmm.hmm_init(seed, obs[0], STEP_N, spec3)
    y5 = obs[5].reshape(1)
    c4 = torch.tensor([1, STEP_N // 3, 2 * STEP_N // 3, 1], dtype=torch.int32, device=dev)
    c1 = torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=dev)
    timing = {
        "spec_init": (
            time_ms(lambda: fused_hmm.hmm_init(seed, obs5[0], SPEC_N, spec5), 10),
            time_ms(lambda: fused_hmm.hmm_init_plain(seed, obs5[0], SPEC_N, spec5), 2)),
        "spec_chunk": (
            time_ms(lambda: fused_hmm.hmm_chunk(seed, s0, w0, ys[0], ctrl, spec5), 10),
            time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, s0, w0, ys[0], ctrl, spec5), 2)),
        "step_exchange": (
            time_ms(lambda: fused_hmm.hmm_chunk(seed, sh, wh, y5, c4, spec3, t0=5,
                                                 count_key="step_exchange"), 20),
            time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, sh, wh, y5, c4, spec3, t0=5), 4)),
        "step_ess": (
            time_ms(lambda: fused_hmm.hmm_chunk(seed, sh, wh, y5, c1, spec3, t0=5,
                                                 count_key="step_ess"), 20),
            time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, sh, wh, y5, c1, spec3, t0=5), 4)),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for K in (12, 32):
        spec_k = spec_from_numpy(*_chain(K))
        obs_k = torch.as_tensor(_chain_obs(K, BIGK_T, K), device=dev)
        sk, wk, _ = fused_hmm.hmm_init(seed, obs_k[0], BIGK_N, spec_k)
        ysk, _ = _chunk_obs(obs_k, BIGK_CHUNK)
        ck = torch.tensor([0, *[BIGK_N * (k + 1) // K for k in range(K - 1)], BIGK_CHUNK],
                          dtype=torch.int32, device=dev)
        print(f"[{card}] spec chunk K={K} n={BIGK_N} {BIGK_CHUNK} steps: kernel "
              f"{time_ms(lambda: fused_hmm.hmm_chunk(seed, sk, wk, ysk[0], ck, spec_k), 10):.4f} ms, "
              f"plain {time_ms(lambda: fused_hmm.hmm_chunk_plain(seed, sk, wk, ysk[0], ck, spec_k), 2):.4f} ms; "
              f"init kernel {time_ms(lambda: fused_hmm.hmm_init(seed, obs_k[0], BIGK_N, spec_k), 10):.4f} ms")
    b2b = time_ms(lambda: run1(20_000, obs5), SWEEPS)
    print(f"[{card}] path 1 back-to-back sweeps: {b2b:.4f} ms each by CUDA events, "
          f"{SPEC_N * T / (b2b * 1e-3):.6g} particle-steps/s; median synced sweep "
          f"{statistics.median(times1) * 1e3:.3f} ms")
    b2b = time_ms(lambda: run2(20_001, obs5), SWEEPS)
    print(f"[{card}] path 2 back-to-back sweeps: {b2b:.4f} ms each by CUDA events, "
          f"{SPEC_N * T / (b2b * 1e-3):.6g} particle-steps/s")
    for K, (runk, ysk) in runs3.items():
        b2b = time_ms(lambda: runk(20_002, ysk), SHORT_SWEEPS)
        print(f"[{card}] path 3 K={K} back-to-back sweeps: {b2b:.4f} ms each by CUDA "
              f"events, {BIGK_N * BIGK_T / (b2b * 1e-3):.6g} particle-steps/s")
    print(f"[{card}] path 4 back-to-back sweeps: chunk=1 (K4) "
          f"{time_ms(lambda: run4(21_000, obs), SHORT_SWEEPS):.4f} ms, smc() (K5) "
          f"{time_ms(lambda: run5(22_000, obs), SHORT_SWEEPS):.4f} ms")
    with stages.stage("spec_profile", sync=True):
        profile_sweeps(run1, obs5, card, trace="spec_sweep_trace.json")

    src = "cpprob_tpu_torch/ops/csrc/fused_hmm.cu"

    bounds = {
        "step_exchange": chain_chunk_bound(STEP_N, 3, 1),
        "step_ess": chain_chunk_bound(STEP_N, 3, 1),
        "spec_chunk": chain_chunk_bound(SPEC_N, 5, int(valid[0])),
        "spec_init": chain_init_bound(SPEC_N, 5),
    }

    def line(name, key, replaces, n_launch):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": errs[key], "ms": timing[key][0],
                "plain_ms": timing[key][1], **bounds[key]}

    return [
        line("hmm_chunk_kernel (n_steps=1, flag and ticks live)", "step_exchange",
             "cpprob_tpu/ops/pallas_hmm.py:103", launches["step_exchange"]),
        line("hmm_chunk_kernel (n_steps=1, flag 0)", "step_ess",
             "cpprob_tpu/ops/pallas_hmm.py:66", launches["step_ess"]),
        line("hmm_chunk_kernel<K> / hmm_chunk_kernel_k (K = 5, 12, 32)", "spec_chunk",
             "cpprob_tpu/ops/pallas_ssm.py:165", launches["chunk"]),
        line("hmm_init_kernel<K> / hmm_init_kernel_k (K = 5, 12, 32)", "spec_init",
             "cpprob_tpu/ops/pallas_ssm.py:331", launches["init"]),
    ]


def user_phases(card, stages):
    """The user-physics family: kernel checks (K10, K11) and their machine
    code, paths 5 and 6, timings beside K7.  Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        linear_gaussian_ssm,
        simulate_observations,
    )
    from cpprob_tpu_torch.ops import fused_lg, user_chunk
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.ops.fused_ssm import (
        attach_fused_scalar_kernels,
        attach_fused_vector_kernels,
    )
    from cpprob_tpu_torch.util.roofline import normal_chunk_bound

    dev = torch.device("cuda")
    with stages.stage("user_kernel_vs_plain", sync=True):
        errs, kernels = check_user_kernels()
        check_user_sass(kernels)
    lg_k, _, vec_k = kernels
    obs = _lg_obs(dev)
    exact = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
    run5 = build_smc_run(attach_fused_scalar_kernels(linear_gaussian_ssm,
                                                     lg_step_elem),
                         USER_N, chunk=LG_CHUNK)
    with stages.stage("user_path5", sync=True):
        got5, times5, _ = run_path(run5, obs, SWEEPS, (user_chunk.LAUNCHES, sr.LAUNCHES),
                                   exact, f"path 5: K10 (LG physics) n={USER_N} chunk={LG_CHUNK}")
    n_ch = -(-(LG_T - 1) // LG_CHUNK)
    # an epoch a chunk, and the close (K14) once a sweep
    _expect(got5, {"scalar": SWEEPS * n_ch, "lse_stats": SWEEPS * (n_ch + 1),
                   "pass1": SWEEPS * n_ch, "pass2": SWEEPS * n_ch}, "path 5")
    vys = _lg2d_obs()
    vobs = torch.as_tensor(vys, device=dev)
    run6 = build_smc_run(attach_fused_vector_kernels(lg2d_model(dev),
                                                     lg2d_step_elem, 2),
                         VEC_N, chunk=VEC_CHUNK)
    with stages.stage("user_path6", sync=True):
        got6, times6, res6 = run_path(run6, vobs, SHORT_SWEEPS, (user_chunk.LAUNCHES,),
                                      kalman_2d_loglik(vys),
                                      f"path 6: K11 (2-D LG) n={VEC_N} chunk={VEC_CHUNK}")
    _expect(got6, {"vector": SHORT_SWEEPS * -(-(len(vys) - 1) // VEC_CHUNK)}, "path 6")
    if res6[0].final_states.shape != (VEC_N, 2):
        raise AssertionError("path 6: final states of the wrong shape")

    seed = CHECK_SEED
    x0, w0 = _lg_population(USER_N, seed, obs)
    ys, valid = _lg_chunks(obs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = lg2d_model(dev)
    xv = model.init_sample_batch(gen, VEC_N)
    wv = model.obs_logpdf_batch(xv, vobs[0], 0)
    vys_c, vvalid = _chunk_obs(vobs, VEC_CHUNK)
    # K10 beside K7, in turns, and K11
    runs = {"K7": lambda: fused_lg.lg_chunk(seed, x0, w0, ys[0], valid[0], t0=1),
            "K10": lambda: lg_k.chunk(seed, x0, w0, ys[0], valid[0], t0=1)}
    turns = {"K10": [], "K7": []}
    for name in ("K10", "K7", "K7", "K10"):
        turns[name].append(time_ms(runs[name], 10))
    print(f"[{card}] K10 (LG physics) beside K7 (n={USER_N}, 8 steps, in turns): "
          + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in t) for k, t in turns.items())
          + " ms")
    timing = {
        "scalar": (statistics.mean(turns["K10"]), time_ms(lambda: user_chunk.user_chunk_plain(
            lg_step_elem, 1, seed, x0, w0, ys[0], valid[0], t0=1), 2)),
        "vector": (time_ms(lambda: vec_k.chunk(seed, xv, wv, vys_c[0], vvalid[0], t0=1), 10),
                   time_ms(lambda: user_chunk.user_chunk_plain(
                       lg2d_step_elem, 2, seed, xv, wv, vys_c[0], vvalid[0], t0=1), 2)),
    }
    for name, (k_ms, plain_ms) in timing.items():
        print(f"[{card}] {name} user kernel: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"[{card}] K10 (LG physics) {timing['scalar'][0]:.4f} ms against K7 "
          f"{statistics.mean(turns['K7']):.4f} ms on the same chunk (n={USER_N}, 8 steps)")
    b2b = time_ms(lambda: run5(20_000, obs), SWEEPS)
    print(f"[{card}] path 5 back-to-back sweeps: {b2b:.4f} ms each by CUDA events, "
          f"{USER_N * LG_T / (b2b * 1e-3):.6g} particle-steps/s; path 6 "
          f"{time_ms(lambda: run6(21_000, vobs), SHORT_SWEEPS):.4f} ms")

    src = "cpprob_tpu_torch/ops/csrc/user_chunk.cuh"
    return [
        {"name": "user_chunk_kernel (D=1, LG physics)", "route": "cuda",
         "source": src, "replaces": "cpprob_tpu/ops/pallas_ssm.py:588",
         "launches": got5["scalar"], "max_abs_err": errs["scalar"],
         "ms": timing["scalar"][0], "plain_ms": timing["scalar"][1],
         **normal_chunk_bound(USER_N, int(valid[0]))},
        {"name": "user_chunk_kernel (D=2, 2-D LG physics)", "route": "cuda",
         "source": src, "replaces": "cpprob_tpu/ops/pallas_ssm.py:730",
         "launches": got6["vector"], "max_abs_err": errs["vector"],
         "ms": timing["vector"][0], "plain_ms": timing["vector"][1],
         **normal_chunk_bound(VEC_N, int(vvalid[0]), D=2, physics_ops=10)},
    ]


# ---------------------------------------------------------------------------
# guided SMC: K12 (the guided linear-Gaussian model; its elementwise twin on
# the FMA pipe and its tensor-core twin, CUDA generated per net) and K13
# (CUDA, the guided 5-state chain)

GUIDED_N = 1 << 24         # paths 7, 8, 9b (examples/kernel_bench.py:192-280)
GUIDED_CHUNK = 8
GUIDED_ISLAND_CHUNK = 16   # path 9b: the guided whole sweep with islands
GUIDED_STEP_N = 1 << 20    # paths 9a, 9c (tests/test_tpu_hw.py:132-159)
GUIDED_STEP_T = 12
GUIDED_STEP_SEED = 3       # observations of test_tpu_hw.py:154
GUIDED_SMC_SWEEPS = 4
# the nets' seeds: the port's initial net at LG_NET_SEED puts no site's
# proposal scale at its floor, so 600 Adam steps reach the reference's loss;
# at some seeds (0, 1, 5) the floor holds some sites and the loss stays
# orders of magnitude higher (an exact estimator still, with a variance 16
# sweeps cannot gate)
LG_NET_SEED = 10
CHAIN_NET_SEED = 6
# K12 against its plain version over its chunks: states and log_w within
# GUIDED_TOL (relative and absolute).  The kernel rounds each multiply-add of
# the net once, the plain version emulates that in float64, which differs
# by an ulp where the float64 sum falls on a float32 tie (rarely); the
# carried state passes such an ulp on through the later steps
GUIDED_TOL = 1e-5
# the K12 instances held to the plain version besides path 7's trained
# [3,16,16,2]: a linear head (no hidden layer), a net wider than the
# tensor-core twin takes, and the path's net with a density that uses **
# (each at GUIDED_EXTRA_N particles)
K12_NETS = ([3, 2], [3, 64, 64, 2])
GUIDED_EXTRA_N = 1 << 20
# K12's tensor-core twin against the same plain version over one step,
# where the net's rounding is not carried through later moves: states and
# log_w within TC_STEP_TOL of 1 + |plain|.  Its products are 3xTF32
# (float32-level, ~2^-21 a product) and its sums take another order: over
# the nets below it read 1.5e-6 to 6.4e-6, its 1xTF32 variant 4.1e-4 to
# 1.4e-2 (an H100 80GB HBM3 at 700 W), so the tolerance sits 3x above the
# one and 20x below the other
TC_STEP_TOL = 2e-5
# the nets the twin is held on besides path 7's trained [3,16,16,2]: the
# sizes of tests/test_torch_guided_tc.py's packing test (padding, two
# hidden->hidden products) and the widest of its narrow layout (32);
# random, seeded, at the trainer's initial scale
TC_NETS = ([3, 8, 8, 2], [3, 24, 24, 2], [3, 16, 16, 16, 2], [3, 32, 32, 2])
# the wide layout's (hidden layers past 32, up to guided_tc_max_width: 64,
# the trainer's default width), at a ragged GUIDED_EXTRA_N
TC_WIDE_NETS = ([3, 48, 48, 2], [3, 64, 64, 2])


def guided_trans_lp_pow(x, nx, t):
    """The transition of ``guided_trans_lp`` with its square written as a
    power, and a small term that takes the other special exponents of
    ``**`` (3, 0.5, -1: torch's float32 pow computes them as a * a * a,
    sqrt and 1 / a, and so does the rendering): K12's check of a density
    with ``**``."""
    d = nx - x
    extra = (1.0 + d ** 2) ** 0.5 - (2.0 + x * x) ** -1 + (0.1 * nx) ** 3
    return -0.5 * d ** 2 - HALF_LOG_2PI + 1e-3 * extra


def train_guides(card, stages):
    """The two proposal nets, trained on the card by the port's trainer with
    the reference's settings (kernel_bench.py:197-200,256-259).  Fails if a
    loss did not fall."""
    from cpprob_tpu_torch.inference.smc_csis import train_ssm_proposal
    from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm
    from cpprob_tpu_torch.ops.fused_ssm import make_fused_discrete_ssm

    nets = {}
    jobs = (("lg", lambda: train_ssm_proposal(
                linear_gaussian_ssm, LG_NET_SEED, LG_T, kind="normal",
                steps=600, batch_size=256, hidden=16, device="cuda")),
            ("chain", lambda: train_ssm_proposal(
                make_fused_discrete_ssm(*_chain(5)), CHAIN_NET_SEED, T,
                kind="discrete", n_states=5, steps=300, batch_size=256,
                hidden=16, device="cuda")))
    for name, job in jobs:
        with stages.stage(f"guided_train_{name}", sync=True):
            params, losses = job()
        losses = losses.cpu()
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        print(f"[{card}] train {name} net {[p['w'].shape[0] for p in params]}"
              f"+[{params[-1]['w'].shape[1]}]: {losses.shape[0]} steps in "
              f"{stages.totals[f'guided_train_{name}']:.2f} s, mean loss first 20 "
              f"{first:.6g}, last 20 {last:.6g}")
        if not last < first:
            raise AssertionError(f"the {name} net's loss did not fall")
        nets[name] = params
    TRAINED_NETS.update(nets)
    return nets["lg"], nets["chain"]


def _tc_net(sizes, seed):
    """A random ``kind="normal"`` net of ``sizes`` on the card, from a
    seeded numpy generator: weights at the trainer's initial scale
    (``mlp_init``: N(0, 2 / fan_in)), biases N(0, 0.1^2); the raw output's
    bias keeps std near 1."""
    import numpy as np

    from cpprob_tpu_torch.interop import mlp_params_from_numpy

    rng = np.random.default_rng(seed)
    layers = [{"w": (math.sqrt(2.0 / a) * rng.standard_normal((a, b))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    layers[-1]["b"][1] += 0.5
    return mlp_params_from_numpy(layers, device="cuda")


def build_twins(twins):
    """Builds the generated sources of K12's kernel objects (either twin),
    one nvcc each, all started together; prints each one's registers and
    spills."""
    from concurrent.futures import ThreadPoolExecutor

    from cpprob_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(twins)) as pool:
        list(pool.map(lambda k: k._library(), twins))
    for k in twins:
        for line in _build.BUILD_LOGS.get(k.library, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.library} {k.layer_sizes()}:", line.strip())


def check_tc_sass(twin):
    """The tensor-core twin's machine code: TF32 ``HMMA`` (mma.sync), and
    no spill and no other local-memory access (``LDL``/``STL``).  Returns
    (registers, spills)."""
    from cpprob_tpu_torch.util.sass import kernel_report

    rep = kernel_report(twin.library, "guided_tc_kernel")
    if len(rep) != 1:
        raise AssertionError(f"guided_tc_kernel: {len(rep)} functions in the library")
    (f, r), = rep.items()
    hmma = {o: c for o, c in r["full"].items() if o.startswith("HMMA")}
    local = sum(c for o, c in r["opcodes"].items() if o in ("LDL", "STL"))
    print(f"SASS guided_tc_kernel {twin.layer_sizes()}: {r['registers']} registers, spills {r['spills']}, {local} local loads "
          f"and stores, {r['instructions']} instructions, {hmma}")
    if not hmma or not all("TF32" in o for o in hmma):
        raise AssertionError("guided_tc_kernel: no TF32 HMMA in its SASS")
    if r["spills"] not in (None, (0, 0)) or local:
        raise AssertionError(f"guided_tc_kernel uses local memory: spills "
                             f"{r['spills']}, {local} LDL/STL")
    return r["registers"], r["spills"]


def _rel_err(got, want):
    """max |got - want| / (1 + |want|)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def check_twin(lg_params, x0, w0, ys, n, seed):
    """K12's tensor-core twin on the card.  One step (n_valid 1, t0 1 and
    2: each half of a Box-Muller pair) against the plain version on path
    7's net and the ``TC_NETS``, and its wide layout on the
    ``TC_WIDE_NETS`` at a ragged ``GUIDED_EXTRA_N``, within
    ``TC_STEP_TOL``; on the same
    inputs its 1xTF32 variant (``util/guided_tc_parts.py`` ``one_tf32``)
    must fall outside it, so the check tells float32-level products from
    TF32-level ones.  Then its chunks (t0 1 and 9, n_valid 8 and 7, a
    ragged n, two nets, and the widest net) against the same steps taken
    one launch at a time,
    bit for bit: the chunk's draws, masking and carried state add nothing
    to a step.  Each build's SASS by ``check_tc_sass``.  Returns the
    largest |dlog_w| against the plain version."""
    from cpprob_tpu_torch.ops.guided_scalar import guided_scalar_chunk_plain
    from cpprob_tpu_torch.ops.guided_tc import GuidedTensorCoreKernel
    from cpprob_tpu_torch.util.guided_tc_parts import variant_kernel

    dev = x0.device
    print(f"K12 mxu (the tensor-core twin) against the same plain version over "
          f"one step: states and log_w within {TC_STEP_TOL} of 1 + |plain| "
          "(3xTF32 products and another order of summation in the net); its "
          "1xTF32 variant must fall outside; slots beyond 1e-5 counted")
    nets = [lg_params] + [_tc_net(sizes, i) for i, sizes in enumerate(TC_NETS)]
    nets += [_tc_net(sizes, 20 + i) for i, sizes in enumerate(TC_WIDE_NETS)]
    sizes_n = [n] * (1 + len(TC_NETS)) + [GUIDED_EXTRA_N - 77] * len(TC_WIDE_NETS)
    twins = [GuidedTensorCoreKernel(p, guided_trans_lp, guided_obs_lp, LG_T) for p in nets]
    controls = [variant_kernel("one_tf32", p, guided_trans_lp, guided_obs_lp, LG_T)
                for p in nets]
    build_twins(twins + controls)
    one = torch.ones((), dtype=torch.int32, device=dev)
    worst = 0.0
    for twin, control, m in zip(twins, controls, sizes_n):
        xs, ws = x0[:m], w0[:m]
        for t0 in (1, 2):
            ys_c = ys[0][t0 - 1:]
            out_k = twin.chunk(seed, xs, ws, ys_c, one, t0=t0)
            out_c = control.chunk(seed, xs, ws, ys_c, one, t0=t0)
            out_p = guided_scalar_chunk_plain(twin.params, guided_trans_lp, guided_obs_lp,
                                              LG_T, seed, xs, ws, ys_c, one, t0=t0)
            _sync()
            what = f"K12 mxu {twin.layer_sizes()} n={m} t0={t0} n_valid=1"
            e_k = max(_rel_err(a, b) for a, b in zip(out_k[:2], out_p[:2]))
            e_c = max(_rel_err(a, b) for a, b in zip(out_c[:2], out_p[:2]))
            dx = float((out_k[0] - out_p[0]).abs().max())
            dw = float((out_k[1] - out_p[1]).abs().max())
            beyond = int(((out_k[0] - out_p[0]).abs() > 1e-5).sum()
                         + ((out_k[1] - out_p[1]).abs() > 1e-5).sum())
            print(f"check {what}: max|d|/(1+|p|) {e_k:.3g} (1xTF32 variant {e_c:.3g}), "
                  f"max|dx|={dx:.3g} max|dlog_w|={dw:.3g}, {beyond} slots beyond 1e-5 "
                  f"(tolerance {TC_STEP_TOL})")
            if not e_k <= TC_STEP_TOL:
                raise AssertionError(f"{what}: {e_k} outside {TC_STEP_TOL}")
            if not e_c > TC_STEP_TOL:
                raise AssertionError(f"{what}: the 1xTF32 variant ({e_c}) passes the "
                                     "check too, so it does not hold the products")
            _close_stats(out_k[2], out_p[2], m, what)
            worst = max(worst, dw)
            del out_k, out_c, out_p

    print("K12 mxu's chunks against the same steps launched one at a time: "
          "states, log_w and records bit-equal")
    cases = [(twins[0], t0, ys_c, nv, n) for t0, ys_c in ((1, ys[0]), (9, ys[1]))
             for nv in (LG_CHUNK, LG_CHUNK - 1)]
    cases += [(twins[0], 1, ys[0], LG_CHUNK, n - 77), (twins[3], 9, ys[1], LG_CHUNK, n),
              (twins[-1], 1, ys[0], LG_CHUNK, sizes_n[-1])]
    for twin, t0, ys_c, nv, m in cases:
        xs, ws = x0[:m], w0[:m]
        out_k = twin.chunk(seed, xs, ws, ys_c, torch.full((), nv, dtype=torch.int32,
                                                          device=dev), t0=t0)
        x, w = xs, ws
        for s in range(nv):
            x, w, rec = twin.chunk(seed, x, w, ys_c[s:], one, t0=t0 + s)
        _sync()
        n_diff = int(((out_k[0] != x) | (out_k[1] != w)).sum())
        print(f"check K12 mxu {twin.layer_sizes()} n={m} t0={t0} n_valid={nv}/{LG_CHUNK} "
              f"against {nv} one-step launches: {n_diff} slots differ, records "
              f"{'equal' if torch.equal(out_k[2], rec) else 'differ'}")
        if n_diff or not torch.equal(out_k[2], rec):
            raise AssertionError(f"K12 mxu n={m} t0={t0} n_valid={nv}: the chunk is not "
                                 "its steps")
        del out_k, x, w
    for twin in twins + controls:
        check_tc_sass(twin)
    return worst


# the benchmark cell guided-lg-2e24-chunk8 (benchmarks/): the launches of
# one of its queries against the cell's plain reference, per particle,
# states and log-weights within CELL_TOL of 1 + |reference| after a chunk
# of up to 8 moves (each step's float32 rounding carried through the later
# ones): the twin read up to 9.0e-6 over a query's 2^24 particles, its
# 1xTF32 variant and the reference with TF32 operands 7.7e-3 (an H100
# 80GB HBM3 at 700 W), so the tolerance sits 5.6x above the one and 150x
# below the other
CELL_TOL = 5e-5


def _bench_file(*parts):
    return os.path.join(REPO, "benchmarks", *parts)


def guided_lg_params(device):
    """The benchmark's committed ``[3,64,64,2]`` net
    (``benchmarks/configs/guided_lg_net.json``) on ``device``."""
    import numpy as np

    from cpprob_tpu_torch.interop import mlp_params_from_numpy

    with open(_bench_file("configs", "guided_lg_net.json")) as f:
        net = json.load(f)
    return mlp_params_from_numpy(
        [{"w": np.asarray(layer["w"], np.float32), "b": np.asarray(layer["b"], np.float32)}
         for layer in net["layers"]], device=device), net


def check_guided_lg_cell(seed=CHECK_SEED):
    """One query of the cell ``guided-lg-2e24-chunk8``: ``build_smc_run(
    model, 2^24, chunk=8)`` on a series of the model, ``model`` built as the
    cell's configuration builds it (the committed net, the default ``mxu``:
    the twin's wide layout); each ``fused_chunk_t_batch`` launch captured by
    a wrapper of the hook and recomputed per particle in float64 by the
    cell's plain reference (``benchmarks/reference/guided_lg.py``: its own
    net, Philox and Box-Muller), states and log-weights within
    ``CELL_TOL``.  The same launches' inputs through the twin's 1xTF32
    variant, and through the reference with the hidden->hidden operands
    rounded to TF32 (``guided_tc._tf32_round_t``), must fall outside it:
    the query's evidence stays exact whatever the net's rounding, so this
    is what holds its precision.  ``guided_tc.wide`` must count the query's
    two launches and ``guided_tc.guided_tc`` none.  Returns (the largest
    |dlog_w|, the query's host ms)."""
    import dataclasses
    import importlib.util

    import numpy as np

    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models.linear_gaussian import kalman_filter_1d, linear_gaussian_ssm
    from cpprob_tpu_torch.ops import guided_tc
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels
    from cpprob_tpu_torch.util.guided_tc_parts import variant_kernel

    spec = importlib.util.spec_from_file_location(
        "guided_lg_reference", _bench_file("reference", "guided_lg.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    with open(_bench_file("configs", "guided_lg.json")) as f:
        cfg = json.load(f)
    with open(_bench_file("traffic", "closed-n2e24-chunk8.json")) as f:
        traffic = json.load(f)
    dev = torch.device("cuda")
    params, net = guided_lg_params(dev)
    T_cfg = int(cfg["series_length"])
    model = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, params, T_cfg, trans_logpdf_elem=guided_trans_lp,
        obs_logpdf_elem=guided_obs_lp)
    hook = model.fused_chunk_t_batch
    launches = []

    def capture(key, states, log_w, ys, n_valid, t0):
        out = hook(key, states, log_w, ys, n_valid, t0)
        launches.append((key, states.clone(), log_w.clone(), ys.clone(), n_valid.clone(),
                         t0, out[0].clone(), out[1].clone()))
        return out

    capture.kernel = hook.kernel
    run = build_smc_run(dataclasses.replace(model, fused_chunk_t_batch=capture),
                        int(traffic["particles"]), ess_threshold=float(traffic["ess_threshold"]),
                        chunk=int(traffic["chunk"]))
    ys_np = ref.simulate(np.random.default_rng(int(traffic["pool_seed"])), 1, cfg)[0]
    obs = torch.as_tensor(ys_np, device=dev)
    run(seed + 1, obs)
    _sync()
    launches.clear()
    before = dict(guided_tc.LAUNCHES)
    t_start = time.perf_counter()
    res = run(seed, obs)
    log_z = float(res.log_evidence)
    query_ms = (time.perf_counter() - t_start) * 1e3
    counted = {k: v - before[k] for k, v in guided_tc.LAUNCHES.items()}
    print(f"cell guided-lg-2e24-chunk8: one query {query_ms:.3f} ms (host clock, synced), "
          f"logZ {log_z:.6f}, Kalman {kalman_filter_1d(ys_np)[2]:.6f}, "
          f"{len(launches)} chunk launches, guided_tc counters {counted}, "
          f"{type(hook.kernel).__name__} wide={hook.kernel.wide}")
    if counted != {"guided_tc": 0, "wide": 2} or len(launches) != 2:
        raise AssertionError(f"guided-lg cell: launches {counted}, expected 2 wide")
    control = variant_kernel("one_tf32", params, guided_trans_lp, guided_obs_lp, T_cfg)
    layers = ref.net_layers(net, dev)
    tf32 = lambda a: guided_tc._tf32_round_t(a.float()).double()
    worst = {"twin": 0.0, "1xTF32 twin": 0.0, "reference, 1xTF32 operands": 0.0}
    dw_max = 0.0
    for key, x_in, w_in, ys_c, n_valid, t0, x_out, w_out in launches:
        nv = int(n_valid)
        ys_l = ys_c[:nv].tolist()
        rx, rw = ref.guided_chunk(layers, cfg, key, x_in, w_in, ys_l, t0, nv)
        cx, cw, _ = control.chunk(key, x_in, w_in, ys_c, n_valid.to(torch.int32), t0=t0)
        ex, ew = ref.guided_chunk(layers, cfg, key, x_in, w_in, ys_l, t0, nv,
                                  round_operands=tf32)
        for name, (gx, gw) in (("twin", (x_out, w_out)), ("1xTF32 twin", (cx, cw)),
                               ("reference, 1xTF32 operands", (ex, ew))):
            e = max(float(((g.double() - r).abs() / (1 + r.abs())).max())
                    for g, r in ((gx, rx), (gw, rw)))
            worst[name] = max(worst[name], e)
        d = (x_out.double() - rx).abs() / (1 + rx.abs())
        print(f"  launch t0={t0} n_valid={nv}: twin max|d|/(1+|ref|) x "
              f"{float(d.max()):.3g} ({int((d > 1e-6).sum())} particles beyond 1e-6), "
              f"log_w {float(((w_out.double() - rw).abs() / (1 + rw.abs())).max()):.3g}")
        dw_max = max(dw_max, float((w_out.double() - rw).abs().max()))
        del rx, rw, cx, cw, ex, ew
    print(f"check guided-lg cell per particle (n={traffic['particles']}, tolerance "
          f"{CELL_TOL} of 1 + |reference|): {worst}")
    if not worst["twin"] <= CELL_TOL:
        raise AssertionError(f"guided-lg cell: the twin {worst['twin']} outside {CELL_TOL}")
    for name in ("1xTF32 twin", "reference, 1xTF32 operands"):
        if not worst[name] > CELL_TOL:
            raise AssertionError(f"guided-lg cell: {name} ({worst[name]}) passes too")
    return dw_max, query_ms


def check_scalar_sass(kernel):
    """K12's machine code: its registers, no spill, and no local memory
    beyond a stack frame no larger than the slow-path argument reduction of
    the precise ``sincosf`` of the Box-Muller draws (:func:`_sincos_frame`),
    which ptxas keeps in some instances and not in others (as
    ``check_user_sass`` allows K10).  Returns (registers, spills, stack
    frame bytes)."""
    from cpprob_tpu_torch.util.sass import kernel_report

    frame = _sincos_frame()
    rep = kernel_report(kernel.library, "guided_scalar_kernel")
    if len(rep) != 1:
        raise AssertionError(f"{kernel.library}: {len(rep)} guided_scalar_kernel functions")
    (f, r), = rep.items()
    ops = r["opcodes"]
    local = ops.get("LDL", 0) + ops.get("STL", 0)
    print(f"SASS guided_scalar_kernel {kernel.layer_sizes()} ({kernel.block() // 256} "
          f"particles a thread): {r['registers']} registers, stack frame {r['stack']} B, "
          f"spills {r['spills']}, {local} LDL/STL, {r['instructions']} instructions, "
          f"FFMA {ops.get('FFMA', 0)}, MUFU {ops.get('MUFU', 0)}, loops {r['loops'][:2]}")
    if r["registers"] is None or r["stack"] is None:
        raise AssertionError(f"{f}: no ptxas report")
    if r["spills"] != (0, 0) or r["stack"] > frame or (local and not r["stack"]):
        raise AssertionError(f"{f} uses local memory beyond the sincosf frame "
                             f"({frame} B)")
    return r["registers"], r["spills"], r["stack"]


def _check_k12(k12, x0, w0, ys_c, n_valid, t0, seed, what):
    """K12 against its plain version on the same inputs, within
    ``GUIDED_TOL``; records by ``_close_stats``.  Returns max |dlog_w|."""
    from cpprob_tpu_torch.ops.guided_scalar import guided_scalar_chunk_plain

    out_k = k12.chunk(seed, x0, w0, ys_c, n_valid, t0=t0)
    out_p = guided_scalar_chunk_plain(k12.params, k12.trans, k12.obs, k12.T, seed,
                                      x0, w0, ys_c, n_valid, t0=t0)
    _sync()
    n_diff = int(((out_k[0] != out_p[0]) | (out_k[1] != out_p[1])).sum())
    dx = float((out_k[0] - out_p[0]).abs().max())
    dw = float((out_k[1] - out_p[1]).abs().max())
    print(f"check {what}: {n_diff} slots not bit-equal, max|dx|={dx:.3g} "
          f"max|dlog_w|={dw:.3g} (tolerance {GUIDED_TOL})")
    torch.testing.assert_close(out_k[0], out_p[0], rtol=GUIDED_TOL,
                               atol=GUIDED_TOL, msg=f"{what}: states")
    torch.testing.assert_close(out_k[1], out_p[1], rtol=GUIDED_TOL,
                               atol=GUIDED_TOL, msg=f"{what}: log_w")
    _close_stats(out_k[2], out_p[2], x0.shape[0], what)
    return dw


def _guided_tables(params):
    import numpy as np

    from cpprob_tpu_torch.ops.fused_hmm import GuidedTables

    return GuidedTables.from_params(np.log(np.maximum(np.array(TRANS5), 1e-38)),
                                    params, T)


def _check_tables(ys, ctrl, spec, gt, t0, what):
    """The tables kernel's rows before n_valid against guided_tables_plain on
    the same device, within 1e-6 relative (the same operations in the same
    order: equal but for a transcendental's last bit).  Returns the largest
    |difference|."""
    from cpprob_tpu_torch.ops.fused_hmm import guided_tables, guided_tables_plain

    dev = ys.device
    got = guided_tables(ys, ctrl, spec, gt, t0=t0)
    tab, gtab = spec.tables(dev), gt.tables(dev)
    rows = []
    for t in range(ys.shape[0]):
        tf = torch.tensor(float(t0 + t), dtype=torch.float32, device=dev) / float(gt.T)
        cum, ssum, rn = guided_tables_plain(tab, gtab, ys[t], tf)
        rows.append(torch.cat([cum.reshape(-1), ssum, rn.reshape(-1)]))
    nv = min(int(ctrl[-1]), ys.shape[0])
    want = torch.stack(rows)[:nv]
    got = got[:nv]
    _sync()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, msg=f"{what}: tables")
    err = float((got - want).abs().max())
    print(f"check {what}: {nv} rows, {int((got != want).sum())} of {got.numel()} "
          f"entries not bit-equal, max|d|={err:.3g}")
    return err


def check_guided_kernels(lg_params, chain_params, n=GUIDED_N,
                         n_step=GUIDED_STEP_N, seed=CHECK_SEED):
    """K12, its tensor-core twin and K13 against their plain versions on
    the card at the guided paths' shapes.  K12 (the LG net, t0 1 and 9,
    n_valid 8 and 7; the ``K12_NETS`` and the LG net with a density that
    uses ``**``, at a ragged ``GUIDED_EXTRA_N``) within ``GUIDED_TOL``, and
    each build's SASS by :func:`check_scalar_sass`; the twin by
    :func:`check_twin`; K13 (the chain's net on K9's population: flag 0 and 1,
    n_valid 8 and 7, island off; the 16-slot chunk with an island check at
    a threshold that fires) and its one-step launch (K = 5, 2^20, flag 0 and
    1) by :func:`_compare_chunk`, as K8: the tables take the same operations
    in the same order on both sides; K13's instances for K = 2, 3, 8 once
    each at 2^20, and at 2^20 K = 1 and two nets past 64 units ([7, 128,
    128, 128, 5] and [7, 2048, 5]).  Returns the largest |dlog_w| of
    each."""
    import numpy as np

    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.ops.fused_hmm import (
        guided_chunk,
        guided_chunk_plain,
        hmm_init,
    )
    from cpprob_tpu_torch.ops.guided_scalar import GuidedScalarKernel

    dev = torch.device("cuda")
    errs = {"guided_scalar": 0.0, "guided_scalar_wide": 0.0, "guided_chunk": 0.0,
            "guided_step": 0.0, "guided_tables": 0.0}
    print(f"K12 against its plain version: states and log_w within {GUIDED_TOL} "
          "(the plain version emulates each fused multiply-add in float64)")
    k12s = [GuidedScalarKernel(lg_params, guided_trans_lp, guided_obs_lp, LG_T)]
    k12s += [GuidedScalarKernel(_tc_net(sizes, 10 + i), guided_trans_lp, guided_obs_lp, LG_T)
             for i, sizes in enumerate(K12_NETS)]
    k12s.append(GuidedScalarKernel(lg_params, guided_trans_lp_pow, guided_obs_lp, LG_T))
    build_twins(k12s)
    k12 = k12s[0]
    obs = _lg_obs(dev)
    x0, w0 = _lg_population(n, seed, obs)
    ys, _ = _lg_chunks(obs)
    for t0, ys_c in ((1, ys[0]), (9, ys[1])):
        for nv in (LG_CHUNK, LG_CHUNK - 1):
            n_valid = torch.full((), nv, dtype=torch.int32, device=dev)
            errs["guided_scalar"] = max(errs["guided_scalar"], _check_k12(
                k12, x0, w0, ys_c, n_valid, t0, seed,
                f"K12 {k12.layer_sizes()} n={n} t0={t0} n_valid={nv}/{LG_CHUNK}"))
    m = GUIDED_EXTRA_N - 77     # ragged: the last CTA part full
    full = torch.full((), LG_CHUNK, dtype=torch.int32, device=dev)
    for k in k12s[1:]:
        density = "trans with **" if k.trans is guided_trans_lp_pow else "LG densities"
        key = "guided_scalar_wide" if k.layer_sizes() == [3, 64, 64, 2] else "guided_scalar"
        for t0, ys_c in ((1, ys[0]), (9, ys[1])):
            errs[key] = max(errs[key], _check_k12(
                k, x0[:m], w0[:m], ys_c, full, t0, seed,
                f"K12 {k.layer_sizes()} ({density}) n={m} t0={t0} "
                f"n_valid={LG_CHUNK}/{LG_CHUNK}"))
    for k in k12s:
        check_scalar_sass(k)

    errs["guided_tc"] = check_twin(lg_params, x0, w0, ys, n, seed)
    del x0, w0

    print("K13 against its plain version: states equal and log_w within 1e-5 "
          "relative, but for at most K-1 slots per fired island (its ticks "
          "come from sums taken in another order)")
    K = 5
    spec5 = spec_from_numpy(*_chain(5))
    gt = _guided_tables(chain_params)
    obs5 = torch.as_tensor(_chain_obs(5, T, 0), device=dev)
    s0, w0, _ = hmm_init(seed, obs5[0], n, spec5)
    ys8, _ = _chunk_obs(obs5, GUIDED_CHUNK)
    ys16, v16 = _chunk_obs(obs5, GUIDED_ISLAND_CHUNK)
    ticks = [n * (k + 1) // K for k in range(K - 1)]
    cases = [(ys8[0], [flag, *ticks, nv], 0, 0.5, None)
             for flag in (0, 1) for nv in (GUIDED_CHUNK, GUIDED_CHUNK - 1)]
    cases += [(ys16[0], [flag, *ticks, int(v16[0])], ISLAND_EVERY, 2.0, "fires")
              for flag in (0, 1)]
    for ys_c, ctrl, every, thresh, want in cases:
        ctrl = torch.tensor(ctrl, dtype=torch.int32, device=dev)
        kw = dict(t0=1, island_every=every, island_thresh=thresh)
        out_k = guided_chunk(seed, s0, w0, ys_c, ctrl, spec5, gt, **kw)
        out_p = guided_chunk_plain(seed, s0, w0, ys_c, ctrl, spec5, gt, **kw)
        _sync()
        what = (f"K13 n={n} flag={int(ctrl[0])} n_valid={int(ctrl[-1])}/"
                f"{ys_c.shape[0]} island_every={every} thresh={thresh}")
        errs["guided_chunk"] = max(errs["guided_chunk"], _compare_chunk(
            out_k, out_p, K, n, what, want))
        del out_k, out_p
    # the tables kernel against guided_tables_plain, row by row, on the card
    for t0, ys_c, nv in ((1, ys8[0], GUIDED_CHUNK), (9, ys8[1], GUIDED_CHUNK - 1),
                         (1, ys16[0], int(v16[0]))):
        ctrl = torch.tensor([0, *ticks, nv], dtype=torch.int32, device=dev)
        errs["guided_tables"] = max(errs["guided_tables"], _check_tables(
            ys_c, ctrl, spec5, gt, t0, f"K13 tables t0={t0} steps={ys_c.shape[0]}"))
    # K13 from t0 = 2, 3, 4 (2, 3, 0 mod 4), and against its one-step launches
    for t0 in (2, 3, 4):
        ctrl = torch.tensor([0, *ticks, GUIDED_CHUNK - 1], dtype=torch.int32, device=dev)
        out_k = guided_chunk(seed, s0, w0, ys8[0], ctrl, spec5, gt, t0=t0)
        out_p = guided_chunk_plain(seed, s0, w0, ys8[0], ctrl, spec5, gt, t0=t0)
        _sync()
        errs["guided_chunk"] = max(errs["guided_chunk"], _compare_chunk(
            out_k, out_p, K, n, f"K13 n={n} t0={t0} flag=0 n_valid="
            f"{GUIDED_CHUNK - 1}/{GUIDED_CHUNK}", None))
        del out_k, out_p
    ctrl = torch.tensor([1, *ticks, GUIDED_CHUNK - 1], dtype=torch.int32, device=dev)
    check_chunk_steps(
        lambda s, w, y, c, t0, every, thresh: guided_chunk(
            seed, s, w, y, c, spec5, gt, t0=t0, island_every=every,
            island_thresh=thresh),
        s0, w0, ys8[0].contiguous(), ctrl, K, f"K13 n={n}", every=3)
    del s0, w0

    s1, w1, _ = hmm_init(seed, obs5[0], n_step, spec5)
    ticks1 = [n_step * (k + 1) // K for k in range(K - 1)]
    for flag in (0, 1):
        ctrl = torch.tensor([flag, *ticks1, 1], dtype=torch.int32, device=dev)
        y5 = obs5[5].reshape(1)
        out_k = guided_chunk(seed, s1, w1, y5, ctrl, spec5, gt, t0=5,
                             count_key="guided_step_exchange")
        out_p = guided_chunk_plain(seed, s1, w1, y5, ctrl, spec5, gt, t0=5)
        _sync()
        errs["guided_step"] = max(errs["guided_step"], _compare_chunk(
            out_k, out_p, K, n_step, f"K13 one-step n={n_step} flag={flag} t=5",
            None))

    # the template's other instances (K = 2, 3, 8), at 2^20 with untrained
    # [K+2, 16, 16, K] nets: flag on, 8 steps, an island check every 4
    from cpprob_tpu_torch.inference.nn import mlp_init
    from cpprob_tpu_torch.ops.fused_hmm import GuidedTables

    for K in (2, 3, 8):
        gen = torch.Generator()
        gen.manual_seed(K)
        gt_k = GuidedTables.from_params(np.log(_chain(K)[0]),
                                        mlp_init([K + 2, 16, 16, K], gen), T)
        spec_k = spec_from_numpy(*_chain(K))
        obs_k = torch.as_tensor(_chain_obs(K, T, K), device=dev)
        sk, wk, _ = hmm_init(seed, obs_k[0], n_step, spec_k)
        ys_k, _ = _chunk_obs(obs_k, GUIDED_CHUNK)
        ctrl = torch.tensor([1, *[n_step * (k + 1) // K for k in range(K - 1)],
                             GUIDED_CHUNK], dtype=torch.int32, device=dev)
        kw = dict(t0=1, island_every=4, island_thresh=2.0)
        errs["guided_tables"] = max(errs["guided_tables"], _check_tables(
            ys_k[0], ctrl, spec_k, gt_k, 1, f"K13 tables K={K}"))
        out_k = guided_chunk(seed, sk, wk, ys_k[0], ctrl, spec_k, gt_k, **kw)
        out_p = guided_chunk_plain(seed, sk, wk, ys_k[0], ctrl, spec_k, gt_k, **kw)
        _sync()
        errs["guided_chunk"] = max(errs["guided_chunk"], _compare_chunk(
            out_k, out_p, K, n_step, f"K13 K={K} n={n_step} flag=1 n_valid="
            f"{GUIDED_CHUNK} island_every=4 thresh=2.0", "fires"))

    # the surface past PR 4's: K = 1 (q = 1: the unguided chunk kernel's
    # run-time-K instance), a wide and deep net, and a net whose activations
    # (2 x 5 x 2048 floats, 80 KB) need the shared-memory opt-in above 48 KB
    for K, sizes in ((1, [3, 16, 16, 1]), (5, [7, 128, 128, 128, 5]),
                     (5, [7, 2048, 5])):
        gen = torch.Generator()
        gen.manual_seed(K)
        gt_k = GuidedTables.from_params(np.log(_chain(K)[0]), mlp_init(sizes, gen), T)
        spec_k = spec_from_numpy(*_chain(K))
        obs_k = torch.as_tensor(_chain_obs(K, T, K), device=dev)
        sk, wk, _ = hmm_init(seed, obs_k[0], n_step, spec_k)
        ys_k, _ = _chunk_obs(obs_k, GUIDED_CHUNK)
        ctrl = torch.tensor([1, *[n_step * (k + 1) // K for k in range(K - 1)],
                             GUIDED_CHUNK], dtype=torch.int32, device=dev)
        kw = dict(t0=1, island_every=4, island_thresh=2.0)
        if K > 1:
            errs["guided_tables"] = max(errs["guided_tables"], _check_tables(
                ys_k[0], ctrl, spec_k, gt_k, 1, f"K13 tables net {sizes}"))
        out_k = guided_chunk(seed, sk, wk, ys_k[0], ctrl, spec_k, gt_k, **kw)
        out_p = guided_chunk_plain(seed, sk, wk, ys_k[0], ctrl, spec_k, gt_k, **kw)
        _sync()
        errs["guided_chunk"] = max(errs["guided_chunk"], _compare_chunk(
            out_k, out_p, K, n_step, f"K13 K={K} net {sizes} n={n_step} flag=1 "
            f"n_valid={GUIDED_CHUNK} island_every=4 thresh=2.0", "fires"))
    return errs


def guided_phases(card, stages):
    """Guided SMC: the two nets trained on the card, K12, its tensor-core
    twin and K13 against their plain versions, paths 7 (with each twin), 8,
    9a, 9b (16 sweeps each) and 9c (``GUIDED_SMC_SWEEPS``), timings.
    Returns the kernel lines."""
    from cpprob_tpu_torch import build_smc_run, smc
    from cpprob_tpu_torch.interop import spec_from_numpy
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        linear_gaussian_ssm,
        simulate_observations,
    )
    from cpprob_tpu_torch.ops import fused_hmm, guided_scalar, guided_tc
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.ops.fused_ssm import (
        attach_fused_guided_discrete_kernels,
        attach_fused_guided_scalar_kernels,
        discrete_hmm_log_evidence,
    )
    from cpprob_tpu_torch.util.roofline import (
        bound,
        guided_net_ops,
        guided_table_ops,
        guided_tc_ops,
    )

    dev = torch.device("cuda")
    lg_params, chain_params = train_guides(card, stages)
    with stages.stage("guided_kernel_vs_plain", sync=True):
        errs = check_guided_kernels(lg_params, chain_params)
    counters = (guided_scalar.LAUNCHES, guided_tc.LAUNCHES, sr.LAUNCHES, fused_hmm.LAUNCHES)

    # path 7: the guided linear-Gaussian model at 8 and 7 steps, with the
    # reference's default (mxu=True: the tensor-core twin) and with
    # mxu=False (K12 on the FMA pipe)
    obs = _lg_obs(dev)
    exact_lg = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
    n_ch = -(-(LG_T - 1) // GUIDED_CHUNK)
    runs7, got7, times7, se7 = {}, {}, {}, {}
    for mxu, key in ((True, "guided_tc"), (False, "guided")):
        lg = attach_fused_guided_scalar_kernels(
            linear_gaussian_ssm, lg_params, LG_T, trans_logpdf_elem=guided_trans_lp,
            obs_logpdf_elem=guided_obs_lp, mxu=mxu)
        runs7[mxu] = build_smc_run(lg, GUIDED_N, chunk=GUIDED_CHUNK)
        if mxu:
            twin7 = lg.fused_chunk_t_batch.kernel
        else:
            k12 = lg.fused_chunk_t_batch.kernel
        with stages.stage(f"guided_path7_mxu_{mxu}", sync=True):
            got7[mxu], times7[mxu], res = run_path(
                runs7[mxu], obs, SWEEPS, counters, exact_lg,
                f"path 7 (mxu={mxu}: {type(lg.fused_chunk_t_batch.kernel).__name__}): "
                f"guided LG n={GUIDED_N} T={LG_T} chunk={GUIDED_CHUNK}",
                epochs_each=False)
        _expect(got7[mxu], {key: SWEEPS * n_ch, "lse_stats": SWEEPS * (n_ch + 1),
                            "pass1": SWEEPS * n_ch, "pass2": SWEEPS * n_ch},
                f"path 7 mxu={mxu}")
        zs = torch.stack([r.log_evidence for r in res]).double()
        se7[mxu] = float(zs.std() / math.sqrt(SWEEPS))
    print(f"path 7: logZ SE over {SWEEPS} sweeps {se7[True]:.3g} (mxu=True) and "
          f"{se7[False]:.3g} (mxu=False)")
    run7 = runs7[True]

    # path 7w: the same model under the benchmark's [3,64,64,2] net (the
    # trainer's default width) with each kernel: the twin's wide layout,
    # counted under "wide" (the narrow key stays still), and K12
    wide_params, _ = guided_lg_params(dev)
    kernels7w, got7w = {}, {}
    for mxu, key in ((True, "wide"), (False, "guided")):
        lg = attach_fused_guided_scalar_kernels(
            linear_gaussian_ssm, wide_params, LG_T, trans_logpdf_elem=guided_trans_lp,
            obs_logpdf_elem=guided_obs_lp, mxu=mxu)
        kernels7w[mxu] = lg.fused_chunk_t_batch.kernel
        with stages.stage(f"guided_path7w_mxu_{mxu}", sync=True):
            got7w[mxu], _, _ = run_path(
                build_smc_run(lg, GUIDED_N, chunk=GUIDED_CHUNK), obs, SWEEPS, counters,
                exact_lg, f"path 7w (mxu={mxu}: {type(kernels7w[mxu]).__name__}, "
                f"[3,64,64,2]): guided LG n={GUIDED_N} T={LG_T} chunk={GUIDED_CHUNK}",
                epochs_each=False)
        _expect(got7w[mxu], {key: SWEEPS * n_ch, "lse_stats": SWEEPS * (n_ch + 1),
                             "pass1": SWEEPS * n_ch, "pass2": SWEEPS * n_ch},
                f"path 7w mxu={mxu}")
    with stages.stage("guided_lg_cell", sync=True):
        errs["guided_tc_wide"], _ = check_guided_lg_cell()

    # path 8: the guided 5-state chain, K9 then K13 at 8 and 7 steps
    ys5 = _chain_obs(5, T, 0)
    exact5 = discrete_hmm_log_evidence(*_chain(5), ys5)
    obs5 = torch.as_tensor(ys5, device=dev)
    g5 = attach_fused_guided_discrete_kernels(*_chain(5), params=chain_params, T=T)
    run8 = build_smc_run(g5, GUIDED_N, chunk=GUIDED_CHUNK)
    with stages.stage("guided_path8", sync=True):
        got8, times8, _ = run_path(
            run8, obs5, SWEEPS, counters, exact5,
            f"path 8: guided chain K=5 (K13) n={GUIDED_N} T={T} chunk={GUIDED_CHUNK}",
            epochs_each=False)
    n_ch8 = -(-(T - 1) // GUIDED_CHUNK)
    _expect(got8, {"init": SWEEPS, "guided_chunk": SWEEPS * n_ch8,
                   "guided_tables": SWEEPS * n_ch8}, "path 8")

    # path 9a: the same model per step (K13 launched for one step)
    ys12 = _chain_obs(5, GUIDED_STEP_T, GUIDED_STEP_SEED)
    exact12 = discrete_hmm_log_evidence(*_chain(5), ys12)
    obs12 = torch.as_tensor(ys12, device=dev)
    run9a = build_smc_run(g5, GUIDED_STEP_N)
    with stages.stage("guided_path9a", sync=True):
        got9a, times9a, _ = run_path(
            run9a, obs12, SWEEPS, counters, exact12,
            f"path 9a: guided chain chunk=1 (K13 one-step) n={GUIDED_STEP_N} "
            f"T={GUIDED_STEP_T}", epochs_each=False)
    _expect(got9a, {"guided_step_exchange": SWEEPS * (GUIDED_STEP_T - 1),
                    "guided_tables": SWEEPS * (GUIDED_STEP_T - 1)}, "path 9a")

    # path 9b: the guided whole sweep with interior island checks
    island_counts = []
    g5i = attach_fused_guided_discrete_kernels(
        *_chain(5), params=chain_params, T=T, island_every=ISLAND_EVERY,
        island_counts=island_counts)
    run9b = build_smc_run(g5i, GUIDED_N, chunk=GUIDED_ISLAND_CHUNK)
    with stages.stage("guided_path9b", sync=True):
        island_counts.clear()
        got9b, times9b, _ = run_path(
            run9b, obs5, SWEEPS, counters, exact5,
            f"path 9b: guided chain K=5 n={GUIDED_N} chunk={GUIDED_ISLAND_CHUNK} "
            f"island_every={ISLAND_EVERY}", epochs_each=False)
    _expect(got9b, {"init": SWEEPS, "guided_chunk": SWEEPS, "guided_tables": SWEEPS},
            "path 9b")
    interior = float(torch.stack(island_counts[-SWEEPS:]).mean())
    print(f"path 9b: interior resamples per island per sweep (mean) {interior:.4f}")
    if not interior > 0:
        raise AssertionError("path 9b: the interior island check never fired")

    # path 9c: smc() with history, the engine's unfused guided step (the
    # same net through proposal_sample / proposal_logpdf): no kernel runs
    run9c = lambda seed, o: smc(g5, o, GUIDED_STEP_N, seed)
    with stages.stage("guided_path9c", sync=True):
        got9c, times9c, res9c = run_path(
            run9c, obs12, GUIDED_SMC_SWEEPS, counters, exact12,
            f"path 9c: guided chain smc() with history n={GUIDED_STEP_N} "
            f"T={GUIDED_STEP_T}", epochs_each=False)
    _expect(got9c, {}, "path 9c")
    if res9c[0].states.shape != (GUIDED_STEP_T, GUIDED_STEP_N):
        raise AssertionError("path 9c: smc() history of the wrong shape")

    # timings at the paths' shapes: K12 on path 7's first chunk, K13 on path
    # 8's (flag 0, 8 steps) and its one-step launch on path 9a's population
    seed = CHECK_SEED
    x0, w0 = _lg_population(GUIDED_N, seed, obs)
    ys, valid = _lg_chunks(obs)
    spec5 = spec_from_numpy(*_chain(5))
    gt = _guided_tables(chain_params)
    s0, wc0, _ = fused_hmm.hmm_init(seed, obs5[0], GUIDED_N, spec5)
    ys8, v8 = _chunk_obs(obs5, GUIDED_CHUNK)
    ticks = [GUIDED_N * (k + 1) // 5 for k in range(4)]
    c8 = torch.tensor([0, *ticks, int(v8[0])], dtype=torch.int32, device=dev)
    s1, w1, _ = fused_hmm.hmm_init(seed, obs12[0], GUIDED_STEP_N, spec5)
    c1 = torch.tensor([1, *[GUIDED_STEP_N * (k + 1) // 5 for k in range(4)], 1],
                      dtype=torch.int32, device=dev)
    y5 = obs12[5].reshape(1)
    # one plain version serves both twins of K12
    plain7 = time_ms(lambda: guided_scalar.guided_scalar_chunk_plain(
        lg_params, guided_trans_lp, guided_obs_lp, LG_T, seed, x0, w0, ys[0],
        valid[0], t0=1), 2)
    plain7w = time_ms(lambda: guided_scalar.guided_scalar_chunk_plain(
        wide_params, guided_trans_lp, guided_obs_lp, LG_T, seed, x0, w0, ys[0],
        valid[0], t0=1), 1)
    timing = {
        "guided_tc": (time_ms(lambda: twin7.chunk(seed, x0, w0, ys[0], valid[0], t0=1),
                              10), plain7),
        "guided_scalar": (time_ms(lambda: k12.chunk(seed, x0, w0, ys[0], valid[0], t0=1),
                                  10), plain7),
        "guided_tc_wide": (time_ms(lambda: kernels7w[True].chunk(
            seed, x0, w0, ys[0], valid[0], t0=1), 10), plain7w),
        "guided_scalar_wide": (time_ms(lambda: kernels7w[False].chunk(
            seed, x0, w0, ys[0], valid[0], t0=1), 10), plain7w),
        "guided_chunk": (
            time_ms(lambda: fused_hmm.guided_chunk(seed, s0, wc0, ys8[0], c8,
                                                    spec5, gt), 10),
            time_ms(lambda: fused_hmm.guided_chunk_plain(seed, s0, wc0, ys8[0],
                                                          c8, spec5, gt), 2)),
        "guided_step": (
            time_ms(lambda: fused_hmm.guided_chunk(
                seed, s1, w1, y5, c1, spec5, gt, t0=5,
                count_key="guided_step_exchange"), 20),
            time_ms(lambda: fused_hmm.guided_chunk_plain(
                seed, s1, w1, y5, c1, spec5, gt, t0=5), 4)),
    }
    timing["guided_tables"] = (
        time_ms(lambda: fused_hmm.guided_tables(ys8[0], c8, spec5, gt), 10),
        time_ms(lambda: fused_hmm.guided_tables(ys8[0].cpu(), c8.cpu(), spec5, gt), 2))
    for name, (ms, plain_ms) in timing.items():
        print(f"[{card}] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # K13 (the tables kernel and the chunk kernel) beside K8, the same
    # particle loop without the tables, at path 8's shapes, in turns
    pair = {"K13": lambda: fused_hmm.guided_chunk(seed, s0, wc0, ys8[0], c8, spec5, gt),
            "K8": lambda: fused_hmm.hmm_chunk(seed, s0, wc0, ys8[0], c8, spec5)}
    turns = {"K13": [], "K8": []}
    for name in ("K13", "K8", "K8", "K13"):
        turns[name].append(time_ms(pair[name], 10))
    print(f"[{card}] K13 beside K8 (K = 5, n={GUIDED_N}, {int(v8[0])} steps, in turns): "
          + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in t) for k, t in turns.items())
          + " ms")
    # K12 beside its tensor-core twin at path 7's shapes, in turns
    turns = {"K12": [], "K12 mxu": []}
    pair = {"K12": lambda: k12.chunk(seed, x0, w0, ys[0], valid[0], t0=1),
            "K12 mxu": lambda: twin7.chunk(seed, x0, w0, ys[0], valid[0], t0=1)}
    for name in ("K12", "K12 mxu", "K12 mxu", "K12"):
        turns[name].append(time_ms(pair[name], 10))
    print(f"[{card}] K12 beside its tensor-core twin ([3,16,16,2], n={GUIDED_N}, "
          f"{int(valid[0])} steps, in turns): "
          + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in t) for k, t in turns.items())
          + " ms")
    # and at the benchmark's [3,64,64,2] net: the twin's wide layout beside K12
    turns = {"K12": [], "K12 mxu": []}
    pair = {"K12": lambda: kernels7w[False].chunk(seed, x0, w0, ys[0], valid[0], t0=1),
            "K12 mxu": lambda: kernels7w[True].chunk(seed, x0, w0, ys[0], valid[0], t0=1)}
    for name in ("K12", "K12 mxu", "K12 mxu", "K12"):
        turns[name].append(time_ms(pair[name], 10))
    print(f"[{card}] K12 beside its tensor-core twin's wide layout ([3,64,64,2], "
          f"n={GUIDED_N}, {int(valid[0])} steps, in turns): "
          + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in t) for k, t in turns.items())
          + " ms")
    print(f"K12 (registers, spills) {check_scalar_sass(k12)}; K12 mxu "
          f"{check_tc_sass(twin7)}; at [3,64,64,2] K12 {check_scalar_sass(kernels7w[False])}, "
          f"K12 mxu {check_tc_sass(kernels7w[True])}")
    for name, run, o, times in (("7 (mxu=True)", runs7[True], obs, times7[True]),
                                ("7 (mxu=False)", runs7[False], obs, times7[False]),
                                ("8", run8, obs5, times8),
                                ("9a", run9a, obs12, times9a),
                                ("9b", run9b, obs5, times9b)):
        n_path = GUIDED_STEP_N if name == "9a" else GUIDED_N
        b2b = time_ms(lambda: run(20_000, o), SWEEPS)
        print(f"[{card}] path {name} back-to-back sweeps: {b2b:.4f} ms each by CUDA "
              f"events, {n_path * o.shape[0] / (b2b * 1e-3):.6g} particle-steps/s; "
              f"median synced sweep {statistics.median(times) * 1e3:.3f} ms")
    print(f"[{card}] path 9c: median synced sweep "
          f"{statistics.median(times9c) * 1e3:.3f} ms (smc() with history)")
    with stages.stage("guided_profile", sync=True):
        profile_sweeps(run7, obs, card, trace="guided_lg_sweep_trace.json")
        profile_sweeps(run8, obs5, card, trace="guided_chain_sweep_trace.json")

    # the bounds: K12 per particle-step half a Philox call and half a pair,
    # the net, softplus (an exp + log1p pair), the move (2), log q (4), the
    # two densities (4 each) and the weight (2); K13 per particle-step a
    # quarter of a Philox call (a uniform: one of its four words, as
    # chain_chunk_bound counts), the target (1), the walk (2(K-1)) and the
    # weight (1), and once per step the tables (the tables kernel's work:
    # the net's weights read, the tables written)
    sizes12 = k12.layer_sizes()
    k12_f32 = guided_net_ops(sizes12) + 14
    table_ops = guided_table_ops(gt.dims, 5)
    net_bytes = 4 * sum((a + 1) * b for a, b in zip(gt.dims[:-1], gt.dims[1:]))

    def tables_bound(steps):
        return bound(net_bytes + 4 * steps * (2 * 25 + 5 + 1), steps * table_ops)

    def k13_bound(n, steps):
        t = tables_bound(steps)["counts"]
        return bound(16 * n + t["bytes"], n * steps * 2 * 5 + t["f32_ops"],
                     philox_calls=n * steps / 4)

    ps12 = GUIDED_N * int(valid[0])
    tc_ops = guided_tc_ops(sizes12)
    wide_sizes = kernels7w[True].layer_sizes()
    wide_ops = guided_tc_ops(wide_sizes)
    bounds = {
        "guided_tc": bound(16 * GUIDED_N, ps12 * tc_ops["f32_ops"],
                           tf32_macs=ps12 * tc_ops["tf32_macs"], philox_calls=ps12 / 2,
                           normal_pairs=ps12 / 2, exp_log_pairs=ps12),
        "guided_scalar": bound(16 * GUIDED_N, ps12 * k12_f32, philox_calls=ps12 / 2,
                               normal_pairs=ps12 / 2, exp_log_pairs=ps12),
        "guided_tc_wide": bound(16 * GUIDED_N, ps12 * wide_ops["f32_ops"],
                                tf32_macs=ps12 * wide_ops["tf32_macs"], philox_calls=ps12 / 2,
                                normal_pairs=ps12 / 2, exp_log_pairs=ps12),
        "guided_scalar_wide": bound(16 * GUIDED_N, ps12 * (guided_net_ops(wide_sizes) + 14),
                                    philox_calls=ps12 / 2, normal_pairs=ps12 / 2,
                                    exp_log_pairs=ps12),
        "guided_chunk": k13_bound(GUIDED_N, int(v8[0])),
        "guided_step": k13_bound(GUIDED_STEP_N, 1),
        "guided_tables": tables_bound(int(v8[0])),
    }
    print(f"bounds: K12 {k12_f32} float operations, half a Philox call and "
          f"Box-Muller pair and one exp + log1p pair per particle-step for the "
          f"{sizes12} net; K12 mxu {tc_ops['tf32_macs']} TF32 multiply-adds and "
          f"{tc_ops['f32_ops']} float operations; K13 tables {table_ops} operations a step; "
          + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
                      for k, v in bounds.items()))

    def line(name, key, route, src, replaces, n_launch):
        return {"name": name, "route": route, "source": src,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": errs[key], "ms": timing[key][0],
                "plain_ms": timing[key][1], **bounds[key]}

    cu = "cpprob_tpu_torch/ops/csrc/fused_hmm.cu"
    return [
        line(f"guided_scalar_kernel (K12, [3,16,16,2] net on the FMA pipe, weights "
             f"baked in, {k12.block() // 256} particles a thread)", "guided_scalar",
             "cuda", "cpprob_tpu_torch/ops/csrc/guided_scalar.cuh",
             "cpprob_tpu/ops/pallas_ssm.py:887", got7[False]["guided"]),
        line(f"guided_tc_kernel (K12 mxu, [3,16,16,2] net, 3xTF32 mma.sync, "
             f"{guided_tc.GROUPS} particles a thread)", "guided_tc", "cuda",
             "cpprob_tpu_torch/ops/csrc/guided_tc.cuh",
             "cpprob_tpu/ops/pallas_ssm.py:948", got7[True]["guided_tc"]),
        line(f"guided_scalar_kernel (K12, [3,64,64,2] net on the FMA pipe, "
             f"{kernels7w[False].block() // 256} particle a thread)", "guided_scalar_wide",
             "cuda", "cpprob_tpu_torch/ops/csrc/guided_scalar.cuh",
             "cpprob_tpu/ops/pallas_ssm.py:887", got7w[False]["guided"]),
        line(f"guided_tc_kernel wide (K12 mxu, [3,64,64,2] net, 3xTF32 mma.sync, "
             f"{kernels7w[True].block() // 256} particles a thread)", "guided_tc_wide", "cuda",
             "cpprob_tpu_torch/ops/csrc/guided_tc.cuh",
             "cpprob_tpu/ops/pallas_ssm.py:948", got7w[True]["wide"]),
        line("guided_chunk_kernel<K> after guided_tables_kernel<K> (K13, K = 5, "
             "[7,16,16,5] net)", "guided_chunk", "cuda", cu,
             "cpprob_tpu/ops/pallas_ssm.py:1351",
             got8["guided_chunk"] + got9b["guided_chunk"]),
        line("guided_chunk_kernel<K> after guided_tables_kernel<K> (K13, n_steps=1, "
             "flag and ticks live)", "guided_step", "cuda", cu,
             "cpprob_tpu/ops/pallas_ssm.py:1351", got9a["guided_step_exchange"]),
        line("guided_tables_kernel<K> (K13's tables, K = 5, [7,16,16,5] net, one CTA "
             "a step)", "guided_tables", "cuda", cu, "cpprob_tpu/ops/pallas_ssm.py:1351",
             got8["guided_tables"] + got9a["guided_tables"] + got9b["guided_tables"]),
    ]


# ---------------------------------------------------------------------------
# R1: the pass-2 variants fast and merge (pass2_tile_kernel)

R1_N = 1 << 24             # the LG path's epoch
R1_EPOCHS = 8              # epochs of each variant through the entry point


def _tile_t(x):
    """The merge layout of a row-major expansion: slot og*128 + s of tile t
    at t*16384 + s*128 + og."""
    return x.view(-1, 128, 128).transpose(1, 2).reshape(-1)


def check_replayed_cells(seeds=(CHECK_SEED + 7, 2 ** 63 + 9)):
    """The four benchmark cells' queries on their main path, the captured
    graph: ``build_smc_run`` at the cells' shapes (the HMM at 2^26, chunk
    16 with island checks; the LG model at 2^24, chunk 8 and per step; the
    guided LG model with the committed net at 2^24, chunk 8), called twice
    outside sync-debug (the first call eager, the second captures), then
    each of ``seeds`` replayed under sync-debug "error", the counters read
    just before and after.  Each replay must equal, bit for bit, the eager
    query of a fresh run of the same seed (``final_states``,
    ``final_log_weights``, ``log_evidence``, ``resampled``): the replay's
    kernels read the graph's device key, the eager query's the key its
    integer seed wrote, so this holds the one to the other at the cells'
    shapes, and the kernel checks above hold them to their plain versions.
    A replay must count each kernel as the eager query does, and
    ``sweep_graph`` one capture and a replay a query.  Returns {cell:
    (launches a replayed query, the graph's pool in bytes)}."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm
    from cpprob_tpu_torch.ops import fused_hmm, fused_lg
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels
    from cpprob_tpu_torch.util.profiling import counters

    dev = torch.device("cuda")
    params, _ = guided_lg_params(dev)
    cells = {
        "hmm3-2e26-chunk16-island8": (lambda: fused_hmm.make_fused_hmm_ssm(
            island_every=ISLAND_EVERY, spec=_spec()), MAIN_N, CHUNK, _observations(dev)),
        "lg1d-2e24-chunk8": (fused_lg.make_fused_lg_ssm, LG_N, LG_CHUNK, _lg_obs(dev)),
        "lg1d-2e24-perstep": (fused_lg.make_fused_lg_ssm, LG_N, 1, _lg_obs(dev)),
        "guided-lg-2e24-chunk8": (lambda: attach_fused_guided_scalar_kernels(
            linear_gaussian_ssm, params, LG_T, trans_logpdf_elem=guided_trans_lp,
            obs_logpdf_elem=guided_obs_lp), GUIDED_N, GUIDED_CHUNK, _lg_obs(dev)),
    }

    def moved(before):
        return {k: v - before.get(k, 0) for k, v in counters().items()
                if v != before.get(k, 0)}

    def kept(res):
        return [t.clone() for t in (res.final_states, res.final_log_weights,
                                    res.log_evidence, res.resampled)]

    out = {}
    for cell, (build, n, chunk, obs) in cells.items():
        model = build()
        run = build_smc_run(model, n, chunk=chunk)
        before = counters()
        run(CHECK_SEED, obs)
        _sync()
        torch.cuda.empty_cache()     # what the capture reserves is its pool's
        reserved = torch.cuda.memory_reserved()
        run(CHECK_SEED + 1, obs)
        _sync()
        pool = torch.cuda.memory_reserved() - reserved
        graph = moved(before)
        if (graph.get("sweep_graph.eager"), graph.get("sweep_graph.capture"),
                graph.get("sweep_graph.replay")) != (1, 1, 1):
            raise AssertionError(f"{cell}: the second call did not capture: {graph}")
        for seed in seeds:
            before = counters()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = kept(run(seed, obs))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _sync()
            replayed = moved(before)
            before = counters()
            eager = kept(build_smc_run(model, n, chunk=chunk)(seed, obs))
            _sync()
            eager_moved = moved(before)
            for name, a, b in zip(("final_states", "final_log_weights", "log_evidence",
                                   "resampled"), got, eager):
                if not torch.equal(a, b):
                    raise AssertionError(f"{cell} seed {seed}: the replay's {name} "
                                         "differs from the eager query's")
            kernels = {k: v for k, v in eager_moved.items() if not k.startswith("sweep_graph")}
            want = {**kernels, "sweep_graph.replay": 1}
            if replayed != want or eager_moved.get("sweep_graph.eager") != 1:
                raise AssertionError(f"{cell}: a replay counted {replayed}, the eager "
                                     f"query {eager_moved}")
        out[cell] = (kernels, pool)
        print(f"replayed cell {cell}: n={n} chunk={chunk}, {len(seeds)} replays under "
              f"sync-debug equal the eager queries bit for bit; launches a query "
              f"{kernels}; the graph's pool {pool / 2 ** 20:.1f} MiB")
        del run, model
        torch.cuda.empty_cache()
    return out


def replay_phases(card, stages):
    """The benchmark cells' main path, the replayed graph
    (:func:`check_replayed_cells`)."""
    with stages.stage("replayed_cells", sync=True):
        check_replayed_cells()


def r1_phases(card, stages):
    """The pass-2 variants ``fast`` and ``merge`` (the kernel of K16, in
    the row-major and the per-tile column-major layout) against their plain
    versions at 2^24 (0 slots may differ), with the flag on, off and
    absent, one heavy particle and the first start slot past 0; the epoch
    through ``streaming_systematic_resample_values(impl=...)`` with the
    launch counts set to 0 just before and read just after; timings of the
    three layouts beside ``torch.repeat_interleave``.  Returns the kernel
    lines."""
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops import stream_resample as sr
    from cpprob_tpu_torch.util.roofline import bound

    dev = torch.device("cuda")
    n = R1_N
    obs = _lg_obs(dev)
    x0, w0 = _lg_population(n, CHECK_SEED, obs)
    ys, valid = _lg_chunks(obs)
    x1, w1, _ = fused_lg.lg_chunk(CHECK_SEED, x0, w0, ys[0], valid[0], t0=1)
    del x0, w0
    u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
    st = sr.resample_pass1(u0, w1, sr.logsumexp_stats(w1))
    on = torch.ones((), dtype=torch.int32, device=dev)
    off = torch.zeros((), dtype=torch.int32, device=dev)
    heavy_w = torch.full((n,), -100.0, device=dev)
    heavy_w[12345] = 0.0
    st_h = sr.resample_pass1(u0, heavy_w, sr.logsumexp_stats(heavy_w))
    st_5 = torch.clamp(st + 5, max=n)       # the first start slot past 0
    errs = {}
    with stages.stage("r1_kernel_vs_plain", sync=True):
        for impl in ("fast", "merge"):
            bad = 0
            for what, s_, flag in (("flag on", st, on), ("no flag", st, None),
                                   ("flag off", st, off),
                                   ("one heavy particle", st_h, None),
                                   ("first start slot 5", st_5, None)):
                got = sr.resample_pass2(s_, x1, flag, impl=impl)
                want = sr.resample_pass2_plain(s_, x1, flag, impl=impl)
                _sync()
                n_bad = int((got != want).sum())
                print(f"check pass2 {impl} n={n} {what}: {n_bad} slots differ from "
                      "the plain version")
                if what == "one heavy particle" and not bool((got == x1[12345]).all()):
                    raise AssertionError(f"pass2 {impl}: the heavy particle does not fill every slot")
                bad += n_bad
            if bad:
                raise AssertionError(f"pass2 {impl}: {bad} slots differ from the plain version")
            errs[impl] = 0.0

    # the path: the epoch a user calls, R1_EPOCHS times per variant, counted
    counters = sr.LAUNCHES
    for k in counters:
        counters[k] = 0
    outs = {}
    with stages.stage("r1_epochs", sync=True):
        for impl in ("fast", "merge"):
            for i in range(R1_EPOCHS):
                gen = torch.Generator(device=dev)
                gen.manual_seed(50_000 + i)
                outs[impl, i] = sr.streaming_systematic_resample_values(
                    gen, w1, x1, impl=impl)
        _sync()
    launches = {k: v for k, v in counters.items() if v}
    _expect(launches, {"lse_stats": 2 * R1_EPOCHS, "pass1": 2 * R1_EPOCHS,
                       "pass2_fast": R1_EPOCHS, "pass2_merge": R1_EPOCHS},
            "R1 epochs")
    for i in range(R1_EPOCHS):
        if not torch.equal(_tile_t(outs["fast", i]), outs["merge", i]):
            raise AssertionError("R1 epochs: merge is not fast's per-tile transpose")
    means = [float(outs["fast", i].double().mean()) for i in range(R1_EPOCHS)]
    wn = torch.softmax(w1.double(), 0)
    wmean = float((wn * x1.double()).sum())
    se = math.sqrt(float((wn * (x1.double() - wmean) ** 2).sum()) / n)
    print(f"R1 epochs: launches {launches}; resampled means "
          f"{[round(m, 6) for m in means]} against the weighted mean {wmean:.6f} "
          f"(SE {se:.3g})")
    if max(abs(m - wmean) for m in means) > 6 * se + 1e-6:
        raise AssertionError("R1 epochs: a resampled mean is off the weighted mean")
    del outs

    counts = torch.diff(st.long(), append=torch.full((1,), n, device=dev))
    timing = {impl: (time_ms(lambda: sr.resample_pass2(st, x1, impl=impl), 20),
                     time_ms(lambda: sr.resample_pass2_plain(st, x1, impl=impl), 4))
              for impl in sr.IMPLS}
    lib_ms = time_ms(lambda: torch.repeat_interleave(x1, counts, output_size=n), 20)
    flag_off_ms = time_ms(lambda: sr.resample_pass2(st, x1, off, impl="fast"), 20)
    for impl, (ms, plain_ms) in timing.items():
        print(f"[{card}] pass2 {impl} at n={n}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
    print(f"[{card}] pass2 at n={n} in the same run: torch.repeat_interleave "
          f"{lib_ms:.4f} ms; fast with the flag off {flag_off_ms:.4f} ms")
    # per slot: the owner scatter, the max-scan and the gather (~3 ops);
    # bytes: the start slots and values read once, the values written
    line = lambda impl, replaces: {
        "name": f"pass2_tile_kernel ({impl})", "route": "cuda",
        "source": "cpprob_tpu_torch/ops/csrc/stream_resample.cu",
        "replaces": replaces, "launches": launches.get(f"pass2_{impl}", 0),
        "max_abs_err": errs[impl], "ms": timing[impl][0],
        "plain_ms": timing[impl][1], **bound(12 * n, 3 * n, library_ms=lib_ms)}
    return [line("fast", "cpprob_tpu/ops/pallas_resample.py:326"),
            line("merge", "cpprob_tpu/ops/pallas_resample.py:164")]


# ---------------------------------------------------------------------------
# slice 4a: the distribution layer on the card (plain PyTorch, no kernel)

DIST_N = 1 << 24          # draws of each scalar class: the LG path's population
MVN_N = 1 << 20           # draws of each multivariate normal, D = MVN_D
MVN_D = 8
DIST_SE = 6               # moments within DIST_SE standard errors
DIST_REL = 1e-6           # card against CPU: |d| / max(|CPU value|, 1)
# Beta's cdf (betainc: 200 float64 steps an element) on the CPU for the
# first 2^20 draws only: all 2^24 would take about a minute there
DIST_BETAINC_CPU_N = 1 << 20


def _truncnorm_moments(a, b):
    """Mean and variance of N(0, 1) truncated to [a, b]."""
    phi = lambda t: math.exp(-0.5 * t * t) / math.sqrt(2 * math.pi)
    cdf = lambda t: 0.5 * (1 + math.erf(t / math.sqrt(2)))
    z = cdf(b) - cdf(a)
    m = (phi(a) - phi(b)) / z
    return m, 1 + (a * phi(a) - b * phi(b)) / z - m * m


def _quadrature_moments(dist_cpu, lo, hi):
    """Mean and variance of a scalar distribution by the trapezoid rule on
    its density over [lo, hi] (float64 grid of 2^20 points)."""
    grid = torch.linspace(lo, hi, 1 << 20, dtype=torch.float64)
    p = torch.exp(dist_cpu.log_prob(grid.float()).double())
    z = float(torch.trapezoid(p, grid))
    m = float(torch.trapezoid(p * grid, grid)) / z
    return m, float(torch.trapezoid(p * (grid - m) ** 2, grid)) / z


def distribution_cases():
    """(name, make(device) -> the distribution on that device, analytic
    (mean, variance), "quadrature" or None) for every scalar class of the
    port's distribution layer, and the compound ones built from them; the
    spline flow in float32 and in float64."""
    import numpy as np

    from cpprob_tpu_torch import distributions as D

    flow = _flow_raw()
    a_mm, b_mm = 0.3 * 4 + 1, 0.7 * 4 + 1
    ex2 = 0.3 * (0.25 + 1.0) + 0.7 * (2.25 + 4.0)
    mix = lambda dv: D.Mixture(D.Normal([-1.0, 2.0], [0.5, 1.5], device=dv), [0.3, 0.7])
    return [
        ("Normal", lambda dv: D.Normal(2.0, 3.0, device=dv), (2.0, 9.0)),
        ("Uniform", lambda dv: D.Uniform(2.0, 9.5, device=dv), (5.75, 7.5 ** 2 / 12)),
        ("Beta", lambda dv: D.Beta(2.0, 3.0, device=dv), (0.4, 0.04)),
        ("Gamma", lambda dv: D.Gamma(2.0, 1.5, device=dv), (3.0, 4.5)),
        ("Laplace", lambda dv: D.Laplace(1.0, 2.0, device=dv), (1.0, 8.0)),
        ("Exponential", lambda dv: D.Exponential(1.7, device=dv), (1 / 1.7, 1 / 1.7 ** 2)),
        ("LogNormal", lambda dv: D.LogNormal(0.5, 0.8, device=dv),
         (math.exp(0.5 + 0.32), (math.exp(0.64) - 1) * math.exp(1.0 + 0.64))),
        ("HalfNormal", lambda dv: D.HalfNormal(2.0, device=dv),
         (2 * math.sqrt(2 / math.pi), 4 * (1 - 2 / math.pi))),
        ("StudentT", lambda dv: D.StudentT(5.0, 1.0, 2.0, device=dv), (1.0, 4 * 5 / 3)),
        ("Cauchy", lambda dv: D.Cauchy(0.5, 1.5, device=dv), None),
        ("MinMaxContinuous", lambda dv: D.MinMaxContinuous(0.0, 10.0, 3.0, 6.0, device=dv),
         (10 * a_mm / (a_mm + b_mm),
          100 * a_mm * b_mm / ((a_mm + b_mm) ** 2 * (a_mm + b_mm + 1)))),
        ("Categorical", lambda dv: D.Categorical([0.2, 0.3, 0.5], device=dv), (1.3, 0.61)),
        ("UniformInt", lambda dv: D.UniformInt(2, 7, device=dv), (4.5, 35 / 12)),
        ("Poisson", lambda dv: D.Poisson(4.2, device=dv), (4.2, 4.2)),
        ("Bernoulli", lambda dv: D.Bernoulli(0.3, device=dv), (0.3, 0.21)),
        ("MinMaxDiscrete", lambda dv: D.MinMaxDiscrete(3, [1.0, 2.0, 1.0], device=dv),
         (4.0, 0.5)),
        ("Mixture", mix, (1.1, ex2 - 1.1 ** 2)),
        ("Truncated (inverse CDF)",
         lambda dv: D.Truncated(D.Normal(0.0, 1.0, device=dv), -1.0, 2.0),
         _truncnorm_moments(-1.0, 2.0)),
        ("Truncated (rejection)", lambda dv: D.Truncated(mix(dv), 0.0, 3.0), "quadrature"),
        ("DefensiveMixture",
         lambda dv: D.DefensiveMixture(D.Normal(2.0, 0.05, device=dv),
                                       D.Uniform(0.0, 4.0, device=dv), 0.25),
         (2.0, 0.75 * 0.05 ** 2 + 0.25 * 16 / 12)),
        ("SplineFlow1D", lambda dv: _flow(flow, torch.float32, dv), "quadrature"),
        ("SplineFlow1D (float64)", lambda dv: _flow(flow, torch.float64, dv), "quadrature"),
    ]


def _flow_raw():
    """Head outputs of the phase's spline flow (K = 8), from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(CHECK_SEED)
    return [rng.normal(size=8), rng.normal(size=8), 0.5 * rng.normal(size=7)]


def _flow(raw, dtype, device):
    """The phase's spline flow: head outputs ``raw``, loc 0.7, scale 1.3."""
    from cpprob_tpu_torch import distributions as D

    return D.SplineFlow1D(*(torch.as_tensor(v, dtype=dtype, device=device)
                            for v in (*raw, 0.7, 1.3)))


def _dist_rel(got, want):
    """|got - want| / max(|want|, 1), 0 where the two are equal (the same
    infinity)."""
    got, want = got.double().cpu(), want.double()
    d = (got - want).abs() / want.abs().clamp(min=1.0)
    return float(torch.where(got == want, 0.0, d).max())


def _dist_moments(x, mean, var, what):
    """The draws' mean and variance within DIST_SE standard errors of
    ``mean`` and ``var``."""
    x = x.double()
    n = x.shape[0]
    m = float(x.mean())
    dev2 = (x - m) ** 2
    v = float(dev2.mean())
    se_m, se_v = math.sqrt(var / n), math.sqrt(float(dev2.var()) / n)
    if abs(m - mean) > DIST_SE * se_m or abs(v - var) > DIST_SE * se_v:
        raise AssertionError(f"distributions {what}: mean {m} (want {mean}, SE "
                             f"{se_m:.3g}), variance {v} (want {var}, SE {se_v:.3g})")
    return (m - mean) / se_m, (v - var) / se_v


def distribution_phases(card, stages):
    """The distribution layer on the card: 2^24 draws of each scalar class
    (and 2^20 of each multivariate normal, D = 8) from a CUDA generator,
    their moments within 6 SE of the analytic ones (by quadrature where
    there is no closed form; the Cauchy's median and quartile mass), and
    ``log_prob`` and ``cdf`` on the card against the same draws' on the
    CPU within ``DIST_REL``; the times of ``sample`` and ``log_prob``."""
    from cpprob_tpu_torch import distributions as D

    dev = torch.device("cuda")
    rows = []
    with stages.stage("distributions", sync=True):
        for i, (name, make, moments) in enumerate(distribution_cases()):
            dist, dist_cpu = make("cuda"), make("cpu")
            gen = torch.Generator(device=dev)
            gen.manual_seed(CHECK_SEED + i)
            x = dist.sample(gen, (DIST_N,))
            if x.shape != (DIST_N,) or x.device.type != "cuda" or not bool(
                    torch.isfinite(x.double()).all()):
                raise AssertionError(f"distributions {name}: draws {x.shape} on "
                                     f"{x.device}, or not finite")
            if moments == "quadrature":
                lo, hi = (0.0, 3.0) if name.startswith("Truncated") else (-16.0, 16.0)
                moments = _quadrature_moments(dist_cpu, lo, hi)
            if moments is None:   # the Cauchy: its median and the mass within a scale
                xd = x.double()
                med = float(xd.median())
                inner = float(((xd - 0.5).abs() <= 1.5).double().mean())
                z = ((med - 0.5) / (math.pi * 1.5 / (2 * math.sqrt(DIST_N))),
                     (inner - 0.5) / math.sqrt(0.25 / DIST_N))
                if max(abs(v) for v in z) > DIST_SE:
                    raise AssertionError(f"distributions {name}: median {med}, mass "
                                         f"within a scale {inner}")
            else:
                z = _dist_moments(x, *moments, name)
            x_cpu = x.cpu()
            lp = dist.log_prob(x)
            lp_cpu = dist_cpu.log_prob(x_cpu)
            if name == "SplineFlow1D":
                # float32 log_prob through the inverse spline's quadratic is
                # conditioned at ~2e-4 relative: the CPU's own float32 value
                # is that far from the float64 flow's on the same points.
                # So the card's float32 value is held to the float64 flow's
                # on the CPU, no farther than twice the CPU's float32 value
                # is (the float64 flow, the next case, is held card against
                # CPU within DIST_REL)
                exact = _flow(_flow_raw(), torch.float64, "cpu").log_prob(x_cpu.double())
                err_cpu = _dist_rel(lp_cpu, exact)
                err = _dist_rel(lp, exact)
                tol = 2 * err_cpu + DIST_REL
                print(f"distributions {name}: float32 log_prob from the float64 "
                      f"flow's: card {err:.3g}, CPU {err_cpu:.3g} (tolerance {tol:.3g})")
            else:
                err, tol = _dist_rel(lp, lp_cpu), DIST_REL
            if hasattr(dist, "cdf") and type(dist).cdf is not D.Distribution.cdf:
                m_cpu = DIST_BETAINC_CPU_N if isinstance(dist, D.Beta) else DIST_N
                err = max(err, _dist_rel(dist.cdf(x)[:m_cpu], dist_cpu.cdf(x_cpu[:m_cpu])))
            if not err <= tol:
                raise AssertionError(f"distributions {name}: card and CPU differ by "
                                     f"{err} (tolerance {tol})")
            sample_ms = time_ms(lambda: dist.sample(gen, (DIST_N,)), 5)
            lp_ms = time_ms(lambda: dist.log_prob(x), 5)
            rows.append((name, z, err, sample_ms, lp_ms))
            del x, x_cpu, lp
        # the multivariate normals, D = 8
        rng = torch.Generator().manual_seed(CHECK_SEED)
        a = torch.randn(MVN_D, MVN_D, generator=rng, dtype=torch.float64)
        cov = a @ a.T / MVN_D + torch.eye(MVN_D, dtype=torch.float64)
        loc = torch.randn(MVN_D, generator=rng)
        scale = torch.rand(MVN_D, generator=rng) + 0.5
        mvns = [("MultivariateNormalDiag",
                 lambda dv: D.MultivariateNormalDiag(loc.to(dv), scale.to(dv)),
                 scale.double() ** 2),
                ("MultivariateNormalFull",
                 lambda dv: D.MultivariateNormalFull.from_covariance(loc.to(dv), cov.float()),
                 torch.diagonal(cov))]
        for j, (name, make, var) in enumerate(mvns):
            dist, dist_cpu = make("cuda"), make("cpu")
            gen = torch.Generator(device=dev)
            gen.manual_seed(CHECK_SEED + 100 + j)
            x = dist.sample(gen, (MVN_N,))
            if x.shape != (MVN_N, MVN_D) or x.device.type != "cuda":
                raise AssertionError(f"distributions {name}: draws {x.shape} on {x.device}")
            z = [_dist_moments(x[:, k], float(loc[k]), float(var[k]), f"{name}[{k}]")
                 for k in range(MVN_D)]
            z = tuple(max(abs(t[c]) for t in z) for c in (0, 1))
            lp = dist.log_prob(x)
            err = _dist_rel(lp, dist_cpu.log_prob(x.cpu()))
            if not err <= DIST_REL:
                raise AssertionError(f"distributions {name}: card and CPU differ by {err}")
            rows.append((name, z, err, time_ms(lambda: dist.sample(gen, (MVN_N,)), 5),
                         time_ms(lambda: dist.log_prob(x), 5)))
    for name, z, err, sample_ms, lp_ms in rows:
        n = MVN_N if name.startswith("Multivariate") else DIST_N
        print(f"[{card}] distributions {name:24s} n={n}: moments at "
              f"{z[0]:+.2f} / {z[1]:+.2f} SE, card against CPU {err:.3g}; sample "
              f"{sample_ms:.4f} ms, log_prob {lp_ms:.4f} ms")
    print(f"distributions: {len(rows)} classes drawn on the card, moments within "
          f"{DIST_SE} SE, log_prob and cdf within {DIST_REL} of the CPU's (the "
          "float32 spline flow within twice the CPU's distance of the float64 flow)")


# ---------------------------------------------------------------------------
# SIS: the trace substrate on the card (slice 4b; plain PyTorch under
# torch.func.vmap, no kernel of its own)

SIS_N = 1 << 20            # the JAX README's headline call: 1,000,000 particles, rounded up
SIS_STREAM_N = 1 << 24     # streaming LG: 16 chunks of SIS_N
SIS_SEEDS = 4              # the rule of __graft_entry__.py:57-63: 4 SE + 0.02 over seeds
SIS_STREAM_SEEDS = 8       # prior SIS on the LG model (T = 16) keeps an ESS of
                           # ~100 at 2^24: eight seeds for its SE
SIS_FLOOR = 0.02
SIS_MARGINAL_TOL = 0.03    # the HMM's smoothed marginals against forward-backward
SIS_TIMED = 8              # synced calls a model, after one warm-up
README_MEAN, README_VAR = 2.32353, 1.05882


def _seed_gate(vals, want, what, floor=SIS_FLOOR):
    """Mean over seeds within 4 SE + floor of ``want`` (elementwise for
    vectors); returns (mean, SE) as lists."""
    cols = list(zip(*[v if isinstance(v, (list, tuple)) else [v] for v in vals]))
    wants = want if isinstance(want, (list, tuple)) else [want]
    out = []
    for col, w in zip(cols, wants):
        mean, se = statistics.mean(col), statistics.stdev(col) / math.sqrt(len(col))
        if not abs(mean - w) <= 4 * se + floor:
            raise AssertionError(f"sis {what}: {mean} (SE {se}) against {w}")
        out.append((mean, se))
    return out


def _no_sync(fn):
    """``fn()`` under sync-debug "error" (the rejection rounds' host reads
    alone are allowed, ``distributions.base.host_any``), then synced."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync()
    return out


def _busy_share(events):
    """(device busy share of the span the events cover, span in µs)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    busy, reach = 0.0, spans[0][0]
    for a, b in spans:
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    span = reach - spans[0][0]
    return busy / span, span


def _time_calls(fn, calls=SIS_TIMED):
    """Median ms of ``calls`` synced calls after one warm-up, each under
    sync-debug "error", and the memory one call allocates at its peak
    beyond what was allocated before it, in MB."""
    _no_sync(fn)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        _no_sync(fn)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _no_sync(fn)
    return statistics.median(times), (torch.cuda.max_memory_allocated() - base) / 2**20


def sis_phases(card, stages):
    """Slice 4b on the card (plain PyTorch under ``torch.func.vmap``, every
    draw from one CUDA generator): ``sis`` at 2^20 on the README Gaussian
    (mean, variance and log-evidence against the conjugate posterior and
    the analytic marginal), the 2-D Gaussian, ``hmm`` and ``hmm_scan``
    (log-evidence against the forward recursion, smoothed marginals
    against forward-backward), both rejection models; ``sis_streaming`` at
    2^24 in chunks of 2^20 on the LG model against Kalman; ``smc`` on the
    LG model with only its per-particle hooks at 2^20 against Kalman.
    Every call runs under sync-debug "error"; the rejection rounds' host
    reads are counted.  Each model's ms a call (median of 8 synced calls
    after a warm-up), launches a call and the device's busy share
    (``torch.profiler``), and the memory a call allocates at its peak."""
    import dataclasses

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch import models as M
    from cpprob_tpu_torch.distributions.base import HOST_READS
    from cpprob_tpu_torch.inference.sis import sis_streaming

    dev = torch.device("cuda")
    seeds = [CHECK_SEED + i for i in range(SIS_SEEDS)]
    obs = _observations(dev)
    lg_obs = _lg_obs(dev)
    lg_exact = M.kalman_filter_1d(lg_obs.cpu().numpy())[2]
    hmm_exact = M.hmm_exact_posterior(obs.cpu().numpy())
    y2 = torch.tensor([3.0, 4.0], device=dev)
    # the README model's marginal: (y1, y2) ~ N((1, 1), [[6.25, 2.25], [2.25, 6.25]])
    det = 6.25 ** 2 - 2.25 ** 2
    d = (2.0, 3.0)
    quad = (6.25 * (d[0] ** 2 + d[1] ** 2) - 2 * 2.25 * d[0] * d[1]) / det
    readme_logz = -0.5 * quad - 0.5 * math.log(det) - math.log(2 * math.pi)
    mu0, var0 = M.gaussian_posterior_analytic([3.0, 4.0])
    v2 = [1.0 / (1.0 / 5.0 + 0.5), 1.0 / (1.0 / 3.0 + 0.5)]
    m2 = [v2[0] * (1.0 / 5.0 + 1.5), v2[1] * (2.0 / 3.0 + 2.0)]
    rows = []

    def sis_case(name, model, args, name_pred, check):
        calls = {}
        for s in seeds:
            before = HOST_READS["rejection_sample"]
            res = _no_sync(lambda: ct.sis(model, args, SIS_N, s, device=dev))
            calls[s] = (res, HOST_READS["rejection_sample"] - before)
        check({s: r for s, (r, _) in calls.items()})
        reads = [n for _, n in calls.values()]
        fn = lambda: ct.sis(model, args, SIS_N, seeds[0], device=dev)
        ms, mb = _time_calls(fn)
        launches, busy = _device_profile(fn, f"sis_{name}_trace.json", calls=2)
        rows.append((name, ms, launches, busy, mb, max(reads)))
        res = calls[seeds[0]][0]
        if res.log_weights.shape != (SIS_N,) or res.log_weights.device.type != dev.type:
            raise AssertionError(f"sis {name}: log-weights {res.log_weights.shape} "
                                 f"on {res.log_weights.device}")
        return calls

    def moments(pred, mean, var, floor_var=0.03):
        def check(res):
            m = [float(r.mean(pred)) for r in res.values()]
            v = [float(r.variance(pred)) for r in res.values()]
            got = _seed_gate(m, mean, f"{pred} mean") + _seed_gate(v, var, f"{pred} variance",
                                                                   floor_var)
            print(f"sis {pred}: mean {got[0][0]:.5f} (SE {got[0][1]:.5f}, want {mean:.5f}), "
                  f"variance {got[1][0]:.5f} (SE {got[1][1]:.5f}, want {var:.5f})")
        return check

    with stages.stage("sis", sync=True):
        def readme_check(res):
            moments("Mean", README_MEAN, README_VAR)(res)
            lz = _seed_gate([float(r.log_evidence) for r in res.values()], readme_logz,
                            "README log-evidence")
            print(f"sis README log-evidence {lz[0][0]:.6f} (SE {lz[0][1]:.6f}, analytic "
                  f"{readme_logz:.6f})")

        sis_case("gaussian_readme", M.gaussian_unknown_mean_readme, (3.0, 4.0), "Mean",
                 readme_check)

        def check_2d(res):
            m = [r.mean("Mu").tolist() for r in res.values()]
            v = [r.variance("Mu").tolist() for r in res.values()]
            got = _seed_gate(m, m2, "2-D mean") + _seed_gate(v, v2, "2-D variance", 0.03)
            print(f"sis 2-D: mean {[round(g[0], 5) for g in got[:2]]} (want "
                  f"{[round(x, 5) for x in m2]}), variance {[round(g[0], 5) for g in got[2:]]} "
                  f"(want {[round(x, 5) for x in v2]})")

        sis_case("gaussian_2d", M.gaussian_2d_unknown_mean, (y2,), "Mu", check_2d)

        hmm_res = {}
        for name, model in (("hmm", M.hmm), ("hmm_scan", M.hmm_scan)):
            def hmm_check(res, name=name):
                lz = _seed_gate([float(r.log_evidence) for r in res.values()], EXACT_LOGZ,
                                f"{name} log-evidence")
                marg = sum(torch.stack([(r.normalized_weights[:, None]
                                         * (r.predicts["State"] == k)).sum(0)
                                        for k in range(3)], 1).double().cpu()
                           for r in res.values()) / len(res)
                err = float((marg - torch.as_tensor(hmm_exact)).abs().max())
                if not err <= SIS_MARGINAL_TOL:
                    raise AssertionError(f"sis {name}: smoothed marginals {err} from "
                                         "forward-backward")
                ess = statistics.mean(float(r.ess) for r in res.values())
                print(f"sis {name}: log-evidence {lz[0][0]:.6f} (SE {lz[0][1]:.6f}, exact "
                      f"{EXACT_LOGZ}), marginals within {err:.4f}, ESS {ess:.1f}")
            hmm_res[name] = sis_case(name, model, (obs,), "State", hmm_check)
        a, b = hmm_res["hmm"][seeds[0]][0], hmm_res["hmm_scan"][seeds[0]][0]
        if not torch.equal(a.predicts["State"], b.predicts["State"]):
            raise AssertionError("sis: hmm_scan's fast path drew other states than hmm")

        for name, model in (("rejection", M.normal_rejection_sampling),
                            ("rejection_guard", M.normal_rejection_sampling_guard)):
            calls = sis_case(name, model, (3.0, 4.0), "Mu", moments("Mu", mu0, var0))
            print(f"sis {name}: host reads (rejection rounds) a call "
                  f"{[n for _, n in calls.values()]}")

        # streaming LG at 2^24 in chunks of 2^20
        stream = lambda s: sis_streaming(M.linear_gaussian_1d, (lg_obs,), SIS_STREAM_N, s,
                                         batch_size=SIS_N, device=dev)
        vals, times = [], []
        for i in range(SIS_STREAM_SEEDS):
            t0 = time.perf_counter()
            res = _no_sync(lambda: stream(CHECK_SEED + i))
            times.append((time.perf_counter() - t0) * 1e3)
            vals.append(float(res.log_evidence))
        lz = _seed_gate(vals, lg_exact, "streaming LG log-evidence")
        stream_ms = statistics.median(times[1:])
        print(f"sis streaming LG n={SIS_STREAM_N}: log-evidence {lz[0][0]:.6f} (SE {lz[0][1]:.6f}, "
              f"Kalman {lg_exact:.6f}), ESS {float(res.ess):.1f}")

        # SMC through the per-particle hooks (vmap), with history
        pp = dataclasses.replace(M.linear_gaussian_ssm, init_sample_batch=None,
                                 step_sample_batch=None, obs_logpdf_batch=None)
        vals = [float(_no_sync(lambda: ct.smc(pp, lg_obs, SIS_N, s)).log_evidence)
                for s in seeds]
        lz = _seed_gate(vals, lg_exact, "per-particle SMC log-evidence")
        smc_fn = lambda: ct.smc(pp, lg_obs, SIS_N, seeds[0])
        smc_ms, smc_mb = _time_calls(smc_fn, 4)
        smc_launches, smc_busy = _device_profile(smc_fn, "sis_pp_smc_trace.json")
        print(f"per-particle SMC (LG, vmapped hooks) n={SIS_N}: log-evidence {lz[0][0]:.6f} "
              f"(SE {lz[0][1]:.6f}, Kalman {lg_exact:.6f})")
    for name, ms, launches, busy, mb, reads in rows:
        print(f"[{card}] sis {name:16s} n={SIS_N}: {ms:9.4f} ms a call (median of "
              f"{SIS_TIMED} synced), {launches:7.1f} launches a call, device busy share "
              f"{busy:.4f}, {mb:.0f} MB at its peak, host reads {reads}")
    print(f"[{card}] sis_streaming LG n={SIS_STREAM_N} (chunks of {SIS_N}): {stream_ms:.4f} ms a "
          f"call (median of {SIS_STREAM_SEEDS - 1} synced)")
    print(f"[{card}] smc LG per-particle hooks n={SIS_N}, T={LG_T}: {smc_ms:.4f} ms a sweep "
          f"(median of 4 synced), {smc_launches:.1f} launches, busy share "
          f"{smc_busy:.4f}, {smc_mb:.0f} MB at its peak")
    print(f"sis: {len(rows)} models at {SIS_N}, streaming at {SIS_STREAM_N} and per-particle SMC "
          "on the card under sync-debug \"error\", every gate held")


# ---------------------------------------------------------------------------
# CSIS: slice 5, inference compilation (plain PyTorch, no kernel of its own)

CSIS_N = 1 << 20           # particles a guided call: SIS_N, the JAX README's headline call
CSIS_E = 128               # the reference's widths: embedding 128, 2-layer LSTM of 128
CSIS_BATCH = 256           # tests/test_csis.py:53-58
CSIS_README_STEPS = 300    # tests/test_csis.py:55-57
CSIS_HMM_STEPS = 400       # cut from 600 to keep the phase near two minutes (PERF.md §4)
CSIS_WARM = 20             # training steps left out of the step-time median
CSIS_OFFLINE_TRACES = 1 << 14
CSIS_SHARD = 4096
CSIS_OFFLINE_STEPS = 100
CSIS_DEFENSIVE = 0.1
DYN_P_MORE, DYN_K_MAX, DYN_OBS_STD = 0.4, 6, 0.5   # tests/test_csis_dynamic.py:20-22
DYN_TRACES = 6000
DYN_E = 32
DYN_BATCH = 64
DYN_N = 2000
DYN_Y = 2.0


def dyn_model(y):
    """tests/test_csis_dynamic.py's model: a geometric number of latent
    sites (a Python ``while`` on sampled values), then mu ~ N(k, 1)."""
    from cpprob_tpu_torch import observe, predict, sample
    from cpprob_tpu_torch.distributions import Bernoulli, Normal

    k = 0
    while k < DYN_K_MAX and int(sample(Bernoulli(DYN_P_MORE), addr=f"more[{k}]")) == 1:
        k += 1
    mu = sample(Normal(float(k), 1.0), addr="mu")
    observe(Normal(mu, DYN_OBS_STD), y, addr="y")
    predict(mu, "Mu")
    return mu


def dyn_exact_mean(y):
    """E[mu | y] of ``dyn_model`` by enumeration of k."""
    v = 1.0 + DYN_OBS_STD ** 2
    post = []
    for k in range(DYN_K_MAX + 1):
        pk = DYN_P_MORE ** k * ((1 - DYN_P_MORE) if k < DYN_K_MAX else 1.0)
        post.append(pk * math.exp(-0.5 * (y - k) ** 2 / v))
    prec = 1.0 + 1.0 / DYN_OBS_STD ** 2
    return sum(p * (k + y / DYN_OBS_STD ** 2) / prec for k, p in enumerate(post)) / sum(post)


def _step_times(events):
    """ms between consecutive CUDA events (read after a sync)."""
    return [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]


def _train_timed(what, train, batch, hook_owner, hook_name):
    """``train()`` under sync-debug "error", with a CUDA event recorded as
    each batch is fetched (``hook_owner.hook_name`` wrapped) and one at the
    end: no sync but at the ends.  Returns (params, losses, median ms a
    step over the steps after CSIS_WARM, traces/s)."""
    events = []
    inner = getattr(hook_owner, hook_name)

    def fetch(*a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return inner(*a)

    def run():
        out = train()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out

    setattr(hook_owner, hook_name, fetch)
    try:
        params, losses = _no_sync(run)
    finally:
        setattr(hook_owner, hook_name, inner)
    ms = statistics.median(_step_times(events)[CSIS_WARM:])
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"csis {what}: a training loss is not finite")
    return params, losses, ms, batch / ms * 1e3


def csis_phases(card, stages):
    """Slice 5 on the card (plain PyTorch, every draw from a CUDA
    generator, the reference's widths: embedding 128, 2-layer LSTM of 128,
    the ``fc`` observation net [obs_dim, 128, 128, 128], heads [128, 128,
    n_out]): ``CSIS`` trained on the README Gaussian (300 Adam steps at
    batch 256) and ``infer`` at 2^20 on (3, 4) and (-1, 0.5) against the
    conjugate posterior, ESS against the prior ``sis``'s; the HMM on the
    headline observations (400 steps), ``infer`` at 2^20 against
    -26.44222 and the forward-backward marginals, with ``defensive=0.1``
    too, and ``infer_many`` over 4 seeds equal to the 4 single calls; the
    tied HMM (``hmm_scan``, ``tie_addresses=True``: guided inference
    through ``scan_sites``' adapter); offline training (2^14 traces dumped
    in shards of 4,096 under ``chiprun_out/csis_traces/``, the native
    ``TraceLoader``, 100 steps of ``compile_offline``, a checkpoint whose
    reload gives the same log-weights bit for bit); ``DynamicCSIS``
    (``compile_vectorized`` and 2,000 serial particles, the gates of
    ``tests/test_csis_dynamic.py``); the entry twin.  Every training step
    and ``infer`` call runs under sync-debug "error" but the dynamic path,
    whose model reads sampled values back (``int(...)``) by design.  Each
    model's training ms a step and traces/s, ms an ``infer`` call at 2^20,
    launches a call, busy share (``chiprun_out/csis_*_trace.json``), peak
    memory and ESS."""
    import numpy as np

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch import models as M
    from cpprob_tpu_torch.entry import entry
    from cpprob_tpu_torch.io.tracefile import TraceLoader
    from cpprob_tpu_torch.util import load_pytree, save_pytree
    from cpprob_tpu_torch.util.pytree import tree_leaves

    dev = torch.device("cuda")
    seeds = [CHECK_SEED + i for i in range(SIS_SEEDS)]
    obs = _observations(dev)
    hmm_exact = torch.as_tensor(M.hmm_exact_posterior(obs.cpu().numpy()))
    rows = []

    def train(name, eng, steps):
        params, losses, ms, rate = _train_timed(
            name, lambda: eng.compile(CHECK_SEED, steps=steps, batch_size=CSIS_BATCH),
            CSIS_BATCH, eng, "_gen")
        first, last = float(losses[0]), float(losses[-10:].mean())
        if not last < first:
            raise AssertionError(f"csis {name}: the loss did not fall ({first} -> {last})")
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[{card}] csis {name} train: {ms:.4f} ms a step (median of steps "
              f"{CSIS_WARM + 1}-{steps}, batch {CSIS_BATCH}), {rate:.1f} traces/s, loss "
              f"{first:.4f} -> {float(losses[-1]):.4f} (last 10: {last:.4f}), "
              f"{n_params} parameters")
        return params, n_params

    def measure(name, fn, guided, prior):
        ms, mb = _time_calls(fn)
        # one call: an HMM call's trace is ~6 MB
        launches, busy = _device_profile(fn, f"csis_{name}_trace.json")
        g, p = float(guided.ess), float(prior.ess)
        rows.append((name, ms, launches, busy, mb, g, p))
        return g, p

    def gated_calls(eng, params, args, **kw):
        return {s: _no_sync(lambda s=s: eng.infer(params, args, CSIS_N, s, **kw))
                for s in seeds}

    with stages.stage("csis", sync=True):
        # README Gaussian
        readme = ct.CSIS(M.gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=CSIS_E)
        rp, _ = train("gaussian_readme", readme, CSIS_README_STEPS)
        res = gated_calls(readme, rp, (3.0, 4.0))
        m = _seed_gate([float(r.mean("Mean")) for r in res.values()], README_MEAN,
                       "csis README mean")
        v = _seed_gate([float(r.variance("Mean")) for r in res.values()], README_VAR,
                       "csis README variance")
        prior = ct.sis(M.gaussian_unknown_mean_readme, (3.0, 4.0), CSIS_N, seeds[0], device=dev)
        g, p = measure("gaussian_readme", lambda: readme.infer(rp, (3.0, 4.0), CSIS_N, seeds[0]),
                       res[seeds[0]], prior)
        if not g > 1.5 * p:
            raise AssertionError(f"csis README: guided ESS {g} not above 1.5x the prior's {p}")
        want, _ = M.gaussian_posterior_analytic([-1.0, 0.5], mu0=1.0, sigma0=1.5, sigma=2.0)
        other = gated_calls(readme, rp, (-1.0, 0.5))
        o = _seed_gate([float(r.mean("Mean")) for r in other.values()], float(want),
                       "csis README mean at (-1, 0.5)")
        print(f"csis README: mean {m[0][0]:.5f} (SE {m[0][1]:.6f}), variance {v[0][0]:.5f} "
              f"(SE {v[0][1]:.6f}); at (-1, 0.5) {o[0][0]:.5f} (want {float(want):.5f}); "
              f"ESS guided {g:.1f} against the prior's {p:.1f}")

        # HMM (the entry's engine at T = 16), untied and tied
        def hmm_gates(name, eng, params, **kw):
            res = gated_calls(eng, params, (obs,), **kw)
            lz = _seed_gate([float(r.log_evidence) for r in res.values()], EXACT_LOGZ,
                            f"csis {name} log-evidence")
            marg = sum(torch.stack([(r.normalized_weights[:, None]
                                     * (r.predicts["State"] == k)).sum(0) for k in range(3)],
                                   1).double().cpu() for r in res.values()) / len(res)
            err = float((marg - hmm_exact).abs().max())
            if not err <= SIS_MARGINAL_TOL:
                raise AssertionError(f"csis {name}: smoothed marginals {err} from "
                                     "forward-backward")
            prior = ct.sis(eng.model, (obs,), CSIS_N, seeds[0], device=dev)
            g, p = float(res[seeds[0]].ess), float(prior.ess)
            if not g > 2.0 * p:
                raise AssertionError(f"csis {name}: guided ESS {g} not above 2x the prior's {p}")
            print(f"csis {name}: log-evidence {lz[0][0]:.6f} (SE {lz[0][1]:.6f}, exact "
                  f"{EXACT_LOGZ}), marginals within {err:.4f}, ESS guided {g:.1f} against "
                  f"the prior's {p:.1f}")
            return res, prior

        untied = ct.CSIS(M.hmm, (obs,), embedding_dim=CSIS_E)
        hp, n_untied = train("hmm", untied, CSIS_HMM_STEPS)
        res, prior = hmm_gates("hmm", untied, hp)
        measure("hmm", lambda: untied.infer(hp, (obs,), CSIS_N, seeds[0]), res[seeds[0]], prior)
        res_d, prior = hmm_gates("hmm_defensive", untied, hp, defensive=CSIS_DEFENSIVE)
        measure("hmm_defensive", lambda: untied.infer(hp, (obs,), CSIS_N, seeds[0],
                                                      defensive=CSIS_DEFENSIVE),
                res_d[seeds[0]], prior)
        many = _no_sync(lambda: untied.infer_many(hp, (obs,), CSIS_N, seeds))
        for i, s in enumerate(seeds):
            if not (torch.equal(many.log_weights[i], res[s].log_weights)
                    and torch.equal(many.predicts["State"][i], res[s].predicts["State"])):
                raise AssertionError(f"csis infer_many: query {i} differs from infer(seed {s})")
        print(f"csis infer_many over {len(seeds)} seeds: equal to the single calls, bit for bit")

        tied = ct.CSIS(M.hmm_scan, (obs,), embedding_dim=CSIS_E, tie_addresses=True)
        tp, n_tied = train("hmm_tied", tied, CSIS_HMM_STEPS)
        res_t, prior = hmm_gates("hmm_tied", tied, tp)
        measure("hmm_tied", lambda: tied.infer(tp, (obs,), CSIS_N, seeds[0]), res_t[seeds[0]],
                prior)
        print(f"csis tied HMM: {n_tied} parameters against the untied engine's {n_untied}")

        # offline: shards, the native loader, compile_offline, a checkpoint
        out_dir = os.path.join(REPO, "chiprun_out", "csis_traces")
        for f in os.listdir(out_dir) if os.path.isdir(out_dir) else []:
            os.unlink(os.path.join(out_dir, f))
        paths = untied.dump_traces(out_dir, CHECK_SEED, CSIS_OFFLINE_TRACES, CSIS_SHARD)
        loader = TraceLoader(paths, CSIS_BATCH, seed=1)
        if not loader.native:
            raise AssertionError("csis: the TraceLoader is not native")
        op, losses, ms, rate = _train_timed(
            "offline", lambda: untied.compile_offline(loader, CHECK_SEED,
                                                      steps=CSIS_OFFLINE_STEPS),
            CSIS_BATCH, loader, "next_batch")
        loader.close()
        head, tail = float(losses[:10].mean()), float(losses[-10:].mean())
        if not tail < head:
            raise AssertionError(f"csis offline: the loss did not fall ({head} -> {tail})")
        ck = save_pytree(os.path.join(REPO, "chiprun_out", "csis_ckpt"), op)
        back = load_pytree(ck, untied.init(0))
        a = _no_sync(lambda: untied.infer(op, (obs,), CSIS_N, seeds[0]))
        b = _no_sync(lambda: untied.infer(back, (obs,), CSIS_N, seeds[0]))
        if not torch.equal(a.log_weights, b.log_weights):
            raise AssertionError("csis: the reloaded checkpoint gives other log-weights")
        print(f"[{card}] csis offline: {len(paths)} shards of {CSIS_SHARD}, native loader, "
              f"{ms:.4f} ms a step, {rate:.1f} traces/s, loss (first 10 / last 10) "
              f"{head:.4f} -> {tail:.4f}; checkpoint reload: log-weights equal bit for bit")

        # dynamic structure (its model reads sampled values: not under "error")
        t0 = time.perf_counter()
        dyn = ct.DynamicCSIS(dyn_model, (0.0,), embedding_dim=DYN_E, bucket_batch=DYN_BATCH)
        dp, stats = dyn.compile_vectorized(CHECK_SEED, n_traces=DYN_TRACES, batch_size=DYN_BATCH)
        _sync()
        t_train = time.perf_counter() - t0
        if not stats["vectorized"] or not np.isfinite(stats["losses"]).all():
            raise AssertionError(f"csis dynamic: {stats['vectorized']}, losses finite "
                                 f"{np.isfinite(stats['losses']).all()}")
        t0 = time.perf_counter()
        guided = dyn.infer(dp, (DYN_Y,), DYN_N, seeds[0])
        t_infer = time.perf_counter() - t0
        prior = ct.sis_host(dyn_model, (DYN_Y,), DYN_N, seeds[1])
        got, want = float(guided.mean("Mu")), dyn_exact_mean(DYN_Y)
        g, p = float(guided.ess), float(prior.ess)
        if not (g > 1.3 * p and abs(got - want) < 0.25):
            raise AssertionError(f"csis dynamic: ESS {g} against the prior's {p}, mean {got} "
                                 f"against {want}")
        print(f"[{card}] csis dynamic: compile_vectorized {DYN_TRACES} traces in "
              f"{t_train:.2f} s ({stats['n_buckets']} buckets), infer {DYN_N} serial particles "
              f"in {t_infer:.2f} s; mean {got:.4f} (enumeration {want:.4f}), ESS {g:.1f} "
              f"against the prior's {p:.1f}")

        fn, args = entry()
        log_w, states = fn(*args)
        if log_w.shape != (128,) or states.shape != (128, 8) or not bool(
                torch.isfinite(log_w).all()):
            raise AssertionError(f"entry twin: {log_w.shape}, {states.shape}")
        print("csis entry twin: log_w (128,), State (128, 8), finite")
    for name, ms, launches, busy, mb, g, p in rows:
        print(f"[{card}] csis infer {name:16s} n={CSIS_N}: {ms:9.4f} ms a call (median of "
              f"{SIS_TIMED} synced), {launches:7.1f} launches a call, device busy share "
              f"{busy:.4f}, {mb:.0f} MB at its peak, ESS {g:.1f} (prior {p:.1f})")
    print("csis: README, HMM, tied HMM, offline, dynamic and the entry twin on the card, "
          "training and infer under sync-debug \"error\" (the dynamic path aside), every "
          "gate held")


# ---------------------------------------------------------------------------
# the gradient-based and second-level engines: slice 6 (plain PyTorch, no
# kernel of its own)

# Chains are the cheap axis on a GPU and transitions the dear one (a
# gradient is ~4 ms of host work whatever the chain count): the
# transitions below are cut from 200 + 100 (HMC), 150 + 50 (ChEES) and
# 150 + 100 (the anisotropic NUTS) to keep the phase near 150 s (PERF.md
# §4)
ENG_CHAINS = 4096          # HMC and ChEES chains
ENG_HMC_WARMUP, ENG_HMC_SAMPLES, ENG_HMC_L = 100, 50, 16   # beta-Bernoulli: 25 samples
ENG_CHEES_WARMUP, ENG_CHEES_SAMPLES, ENG_CHEES_L = 60, 20, 64
ENG_NUTS_CHAINS, ENG_NUTS_DEPTH = 1024, 6      # the quickstart's max_depth
ENG_NUTS_WARMUP, ENG_NUTS_SAMPLES = 150, 100   # the README Gaussian
ENG_NUTS_ANISO_WARMUP, ENG_NUTS_ANISO_SAMPLES = 100, 50
ENG_SVI_STEPS = 1500       # the quickstart's
ENG_SVI_FR_STEPS = 3000    # tests/test_hmc_svi.py's full-rank run
ENG_DRAWS = 1 << 20        # SVIResult.sample and the prior predictive
ENG_SMC_N = 1 << 20        # the tempered sampler's particles
ENG_PG_N, ENG_PG_ITERS, ENG_PG_BURN = 1024, 600, 100
ENG_SMC2_N = 1024          # N_theta = N_x
ENG_POSITIONS = 4096       # flatten_model: the card against the CPU
ENG_FLAT_TOL = 1e-5        # relative, on the log-joint and its gradient
ENG_SEEDS = 4              # 4 SE + 0.02 over seeds where an evidence is exact
ENG_PROFILED = 2           # transitions, SVI steps / 4 or sweeps profiled
ENG_GRAD_TIMED = 16        # back-to-back gradients timed
BB_DATA = (1, 1, 1, 0, 1, 1, 0, 1, 1, 1)       # tests/test_hmc_svi.py:95-107
REG_PTS = ((1, 2.1), (2, 3.9), (3, 5.3), (4, 7.7), (5, 10.2), (6, 12.9))
FR_Y = (1.5, -0.5)         # tests/test_hmc_svi.py's correlated model


def engine_models():
    """The models of the engine phase, from the JAX package's tests:
    beta-Bernoulli and the two-latent regression (``tests/test_hmc_svi.py``),
    the anisotropic Gaussian (``tests/test_nuts.py:25-42``), the correlated
    Gaussian of the full-rank guide, and ``tests/test_smc2.py``'s
    random walk with an unknown observation scale."""
    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch.distributions import (
        Bernoulli,
        Beta,
        MultivariateNormalDiag,
        Normal,
    )
    from cpprob_tpu_torch.inference.smc2 import ParamSSM

    def beta_bernoulli(y):
        p = ct.sample(Beta(2.0, 2.0), addr="p")
        for i in range(len(y)):
            ct.observe(Bernoulli(p), y[i], addr=f"y[{i}]")

    def regression(points):
        a = ct.sample(Normal(0.0, 10.0), addr="a")
        b = ct.sample(Normal(0.0, 10.0), addr="b")
        for i, (x, y) in enumerate(points):
            ct.observe(Normal(a * x + b, 1.0), y, addr=f"y[{i}]")

    def anisotropic():
        ct.sample(MultivariateNormalDiag([1.0, -2.0], [10.0, 0.1]), addr="x")

    def correlated(y):
        x0 = ct.sample(Normal(0.0, 1.0), addr="x0")
        x1 = ct.sample(Normal(0.0, 1.0), addr="x1")
        ct.observe(Normal(x0 + x1, 0.5), y[0], addr="y0")
        ct.observe(Normal(x1, 0.5), y[1], addr="y1")

    def randn(g):
        return torch.randn((), generator=g, device=g.device)

    smc2_model = ParamSSM(
        prior_sample=lambda g: {"log_sigma": 0.5 * randn(g)},
        prior_logpdf=lambda th: Normal(0.0, 0.5, device=th["log_sigma"].device).log_prob(
            th["log_sigma"]),
        init_sample=lambda g, th: randn(g),
        step_sample=lambda g, x, t, th: x + randn(g),
        obs_logpdf=lambda x, y, t, th: Normal(x, torch.exp(th["log_sigma"])).log_prob(y),
    )
    return beta_bernoulli, regression, anisotropic, correlated, smc2_model


def smc2_data():
    """``tests/test_smc2.py``'s observations (T = 25, true sigma 1.5) and
    the quadrature over log sigma of the Kalman evidence."""
    import numpy as np

    rng = np.random.RandomState(0)
    x, ys = 0.0, []
    for _ in range(25):
        x = rng.normal(x, 1.0)
        ys.append(rng.normal(x, 1.5))
    ys = np.asarray(ys, np.float32)

    def kalman_ll(r):
        m, p, ll = 0.0, 1.0, 0.0
        for y in ys.astype(np.float64):
            s = p + r
            ll += -0.5 * (y - m) ** 2 / s - 0.5 * math.log(2 * math.pi * s)
            k = p / s
            m, p = m + k * (y - m), (1.0 - k) * p + 1.0
        return ll

    grid = np.linspace(-1.6, 1.6, 81)
    lp = np.array([kalman_ll(math.exp(2 * g)) - 0.5 * (g / 0.5) ** 2
                   - math.log(0.5 * math.sqrt(2 * math.pi)) for g in grid])
    w = np.exp(lp - lp.max())
    log_z = math.log(float(((w[1:] + w[:-1]) / 2).sum() * (grid[1] - grid[0]))) + lp.max()
    return ys, log_z


def _engine_call(fn):
    """``fn()`` under sync-debug "error", synced: (result, ms, the memory
    it allocates at its peak beyond what was allocated before, in MB, host
    reads counted in ``HOST_READS``)."""
    from cpprob_tpu_torch.distributions.base import HOST_READS

    before = dict(HOST_READS)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = _no_sync(fn)
    ms = (time.perf_counter() - t0) * 1e3
    mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    return out, ms, mb, sum(HOST_READS[k] - before[k] for k in HOST_READS)


def _grad_ms(fn, z):
    """ms a gradient evaluation of ``fn`` over the population ``z``,
    back to back under sync-debug "error" (one sync at the end)."""
    from cpprob_tpu_torch.inference.potential import batched_grad

    vgrad = batched_grad(fn)
    _no_sync(lambda: vgrad(z))
    t0 = time.perf_counter()
    _no_sync(lambda: [vgrad(z) for _ in range(ENG_GRAD_TIMED)])
    return (time.perf_counter() - t0) * 1e3 / ENG_GRAD_TIMED


def _device_profile(fn, trace, calls=1, attempts=3):
    """torch.profiler's device activity (no host operators: a trace of an
    engine's host-bound call would hold hundreds of thousands) over
    ``calls`` back-to-back calls of ``fn``: kernel launches a call (the
    host's launch calls) and the device's busy share.

    The profiler records no kernel for the launches of the first ~1.3 ms
    of its window (11 of a README SIS window's 86, all before the first
    kernel event), so the window opens with 32 warm-up launches, a
    device sync and 20 ms of sleep, and only what follows that sync is
    counted.  Now and then it also delivers none or only part of a
    window's device events while its launch calls are all there (seen
    128 s into a process, with no clock drift before or after), so a
    window whose kernels fall short of its launches by more than 10 % is
    taken again, up to ``attempts`` windows.  The trace, the counted
    device events alone with names cut to 96 characters, goes to
    chiprun_out/``trace``."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(REPO, "chiprun_out", trace)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    warm = torch.zeros(1, device="cuda")
    for _ in range(attempts):
        _sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                warm.add_(1)
            _sync()
            time.sleep(0.02)
            for _ in range(calls):
                fn()
            _sync()
        prof.export_chrome_trace(out)
        with open(out) as f:
            dev, kernels, launches = _counted_window(json.load(f)["traceEvents"])
        if dev and kernels >= 0.9 * launches:
            break
    else:
        raise AssertionError(f"{trace}: {kernels} kernels recorded of {launches} launched")
    with open(out, "w") as f:
        json.dump({"traceEvents": [{k: (v[:96] if k == "name" else v) for k, v in e.items()
                                    if k != "args"} for e in dev]}, f)
    busy, _ = _busy_share(dev)
    return launches / calls, busy


def _counted_window(events):
    """The part of a profiler window after its first device sync (the
    warm-up's): its device events, the kernels among them whose launch
    falls after the sync, and those launches."""
    syncs = [e for e in events
             if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaDeviceSynchronize"]
    after = min(e["ts"] + e.get("dur", 0) for e in syncs) if syncs else float("-inf")
    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "") and e["ts"] >= after}
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
           and e["ts"] >= after]
    kernels = sum(e.get("cat") == "kernel"
                  and e.get("args", {}).get("correlation") in launched for e in dev)
    return dev, kernels, len(launched)


def _within(got, want, tol, what):
    if not abs(got - want) <= tol:
        raise AssertionError(f"engines {what}: {got} against {want} (tolerance {tol})")


def engine_phases(card, stages):
    """Slice 6 on the card (plain PyTorch under ``torch.func.vmap`` and
    ``torch.func.grad``, every draw from one CUDA generator): the
    log-joint and its gradient of three models at 4,096 positions against
    the CPU's; ``hmc`` (4,096 chains, warmup 100, samples 50 or 25, 16
    leapfrogs) on the README Gaussian and beta-Bernoulli, ``chees_hmc``
    (4,096 chains, warmup 60, samples 20, up to 64 leapfrogs) and
    ``nuts`` (1,024 chains, depth 6; warmup 150 and samples 100 on the
    README Gaussian, 100 and 50 on the anisotropic Gaussian); ``svi`` mean-field (1,500
    steps) and full-rank (3,000), ``SVIResult.sample`` at 2^20; the
    posterior predictive over the HMC draws and the prior predictive at
    2^20; ``smc_sampler`` at 2^20 (3 moves; waste-free, chains of 8;
    beta-Bernoulli); ``particle_gibbs`` on the HMM (1,024 particles, 600
    iterations, burn-in 100) against forward-backward; ``smc2`` at 1,024 x
    1,024 against the Kalman quadrature.  The gates are the JAX tests'
    tolerances, or 4 SE + 0.02 over 4 seeds where an evidence is exact.
    Every call runs under sync-debug "error"; the counted host reads of
    NUTS, the tempered sampler and SMC² are the only syncs.  Each engine's
    ms a call, ms a gradient evaluation, launches a transition, stage,
    step or iteration, busy share (``chiprun_out/engine_*_trace.json``),
    peak memory and host reads."""
    import numpy as np

    import cpprob_tpu_torch as ct
    from cpprob_tpu_torch import models as M
    from cpprob_tpu_torch.inference.chees import chees_hmc, make_chees_kernel
    from cpprob_tpu_torch.inference.hmc import make_hmc_kernel
    from cpprob_tpu_torch.inference.nuts import make_nuts_kernel
    from cpprob_tpu_torch.inference.potential import batched_grad, flatten_model
    from cpprob_tpu_torch.inference.predictive import posterior_predictive, prior_predictive
    from cpprob_tpu_torch.inference.smc2 import smc2
    from cpprob_tpu_torch.inference.smc_sampler import _split_log_joint

    dev = torch.device("cuda")
    seeds = [CHECK_SEED + i for i in range(ENG_SEEDS)]
    readme = (M.gaussian_unknown_mean_readme, (3.0, 4.0))
    beta_bernoulli, regression, anisotropic, correlated, smc2_model = engine_models()
    bb = (beta_bernoulli, (BB_DATA,))
    rows = []

    t_phase = time.perf_counter()

    def row(name, ms, grad_ms, unit, prof, mb, reads):
        launches, busy = prof
        rows.append((name, ms, grad_ms, unit, launches, busy, mb, reads))
        print(f"engines {name}: row recorded at {time.perf_counter() - t_phase:.1f} s of the "
              "phase")

    def profile(name, fn, units):
        launches, busy = _device_profile(fn, f"engine_{name}_trace.json")
        return launches / units, busy

    def moments(res, addr):
        x = res.samples[addr].reshape(-1).double()
        return float(x.mean()), float(x.var())

    with stages.stage("engines", sync=True):
        # the log-joint and its gradient: the card against the CPU
        for name, (model, args) in (("readme", readme), ("beta_bernoulli", bb),
                                    ("regression", (regression, (REG_PTS,)))):
            fc, fh = flatten_model(model, args, dev), flatten_model(model, args, "cpu")
            g = torch.Generator().manual_seed(CHECK_SEED)
            z = 1.5 * torch.randn((ENG_POSITIONS, fh.dim), generator=g)
            zc = z.to(dev)
            gc, uc = _no_sync(lambda: batched_grad(fc.potential)(zc))
            lc = _no_sync(lambda: torch.func.vmap(fc.log_joint)(zc))
            gh, uh = batched_grad(fh.potential)(z)
            lh = torch.func.vmap(fh.log_joint)(z)
            for what, a, b in (("log-joint", lc, lh), ("potential", uc, uh), ("gradient", gc, gh)):
                err = float(((a.cpu() - b).abs() / (b.abs() + 1.0)).max())
                if not err <= ENG_FLAT_TOL:
                    raise AssertionError(f"engines flatten_model {name}: {what} {err} from the CPU")
            print(f"engines flatten_model {name} (dim {fh.dim}) at {ENG_POSITIONS} positions: "
                  f"log-joint and gradient on the card within {ENG_FLAT_TOL} (relative) of the CPU")

        # HMC
        flat = flatten_model(*readme, dev)
        gen = torch.Generator(device=dev).manual_seed(CHECK_SEED)    # profiled transitions
        for name, (model, args), n_samples in (("hmc_readme", readme, ENG_HMC_SAMPLES),
                                               ("hmc_beta_bernoulli", bb, ENG_HMC_SAMPLES // 2)):
            res, ms, mb, reads = _engine_call(lambda: ct.hmc(
                model, args, seeds[0], n_samples=n_samples, n_warmup=ENG_HMC_WARMUP,
                n_chains=ENG_CHAINS, max_leapfrog=ENG_HMC_L, device=dev))
            if name == "hmc_readme":
                hmc_readme = res
                m, v = moments(res, "mu")
                _within(m, README_MEAN, 0.05, "hmc README mean")
                _within(v, README_VAR, 0.12, "hmc README variance")
                _within(float(res.accept_rate.mean()), 1.0, 0.4, "hmc accept rate")
                f = flat
            else:
                m, v = moments(res, "p")
                _within(m, 10.0 / 14.0, 0.03, "hmc beta-Bernoulli mean")
                if not 0.0 < float(res.samples["p"].min()) <= float(res.samples["p"].max()) < 1.0:
                    raise AssertionError("hmc beta-Bernoulli: a draw off (0, 1)")
                f = flatten_model(model, args, dev)
            print(f"engines {name}: mean {m:.5f}, variance {v:.5f}, accept "
                  f"{float(res.accept_rate.mean()):.4f}, step {float(res.step_size):.4f}")
            z, eps, im = res.positions[:, -1].contiguous(), res.step_size, res.inv_mass
            kernel = make_hmc_kernel(f.potential, ENG_HMC_L)
            row(name, ms, _grad_ms(f.potential, z), "transition",
                profile(name, lambda: [kernel(gen, z, eps, im) for _ in range(ENG_PROFILED)],
                        ENG_PROFILED), mb, reads)

        # ChEES
        res, ms, mb, reads = _engine_call(lambda: chees_hmc(
            *readme, seeds[0], n_samples=ENG_CHEES_SAMPLES, n_warmup=ENG_CHEES_WARMUP,
            n_chains=ENG_CHAINS, max_leapfrog=ENG_CHEES_L, device=dev))
        m, v = moments(res, "mu")
        _within(m, README_MEAN, 0.05, "chees README mean")
        _within(v, README_VAR, 0.12, "chees README variance")
        _within(float(res.accept_rate.mean()), 1.0, 0.5, "chees accept rate")
        print(f"engines chees_readme: mean {m:.5f}, variance {v:.5f}, accept "
              f"{float(res.accept_rate.mean()):.4f}, step {float(res.step_size):.4f}")
        z, eps, im = res.positions[:, -1].contiguous(), res.step_size, res.inv_mass
        kernel = make_chees_kernel(flat.potential, ENG_CHEES_L)
        n_sel = torch.ones((), dtype=torch.int32, device=dev)
        row("chees_readme", ms, _grad_ms(flat.potential, z), "transition",
            profile("chees_readme", lambda: kernel(gen, z, eps, im, n_sel), 1),
            mb, reads)

        # NUTS
        for name, (model, args) in (("nuts_readme", readme), ("nuts_anisotropic", (anisotropic, ()))):
            n_warmup, n_samples = ((ENG_NUTS_WARMUP, ENG_NUTS_SAMPLES) if name == "nuts_readme"
                                   else (ENG_NUTS_ANISO_WARMUP, ENG_NUTS_ANISO_SAMPLES))
            res, ms, mb, reads = _engine_call(lambda: ct.nuts(
                model, args, seeds[0], n_samples=n_samples, n_warmup=n_warmup,
                n_chains=ENG_NUTS_CHAINS, max_depth=ENG_NUTS_DEPTH, device=dev))
            if name == "nuts_readme":
                m, v = moments(res, "mu")
                _within(m, README_MEAN, 0.05, "nuts README mean")
                _within(v, README_VAR, 0.12, "nuts README variance")
                _within(float(res.accept_rate.mean()), 1.0, 0.4, "nuts accept rate")
                f, what = flat, f"mean {m:.5f}, variance {v:.5f}"
            else:
                x = res.samples["x"].reshape(-1, 2).double()
                mx, sx = x.mean(0).tolist(), x.std(0).tolist()
                _within(mx[0], 1.0, 0.6, "nuts anisotropic mean x0")
                _within(mx[1], -2.0, 0.02, "nuts anisotropic mean x1")
                _within(sx[0], 10.0, 1.5, "nuts anisotropic std x0")
                _within(sx[1], 0.1, 0.02, "nuts anisotropic std x1")
                f = flatten_model(model, args, dev)
                what = f"means {mx[0]:.4f}, {mx[1]:.5f}, stds {sx[0]:.4f}, {sx[1]:.5f}"
            print(f"engines {name}: {what}, accept {float(res.accept_rate.mean()):.4f}, step "
                  f"{float(res.step_size):.4f}, host reads {reads} "
                  f"({reads / (n_warmup + n_samples):.2f} a transition)")
            z, eps, im = res.positions[:, -1].contiguous(), res.step_size, res.inv_mass
            kernel = make_nuts_kernel(f.potential, ENG_NUTS_DEPTH)
            row(name, ms, _grad_ms(f.potential, z), "transition",
                profile(name, lambda: [kernel(gen, z, eps, im) for _ in range(ENG_PROFILED)],
                        ENG_PROFILED), mb, reads)

        # SVI: mean-field over seeds, full-rank on the correlated model
        means, variances, times = [], [], []
        for s in seeds:
            res, ms, mb, reads = _engine_call(lambda: ct.svi(
                *readme, s, steps=ENG_SVI_STEPS, device=dev))
            draws, d_ms, d_mb, _ = _engine_call(lambda: res.sample(s, ENG_DRAWS))
            x = draws["mu"].double()
            means.append(float(x.mean()))
            variances.append(float(x.var()))
            times.append(ms)
            if not float(res.losses[-50:].mean()) < float(res.losses[:50].mean()):
                raise AssertionError("svi: the loss did not fall")
        m, v = statistics.mean(means), statistics.mean(variances)
        _within(m, README_MEAN, 0.06, f"svi mean-field mean over {ENG_SEEDS} seeds")
        _within(v, README_VAR, 0.15, f"svi mean-field variance over {ENG_SEEDS} seeds")
        print(f"engines svi mean-field ({ENG_SVI_STEPS} steps, {ENG_SEEDS} seeds): mean {m:.5f} "
              f"(SE {statistics.stdev(means) / 2:.5f}), variance {v:.5f} (SE "
              f"{statistics.stdev(variances) / 2:.5f}); sample at {ENG_DRAWS}: {d_ms:.4f} ms, "
              f"{d_mb:.0f} MB")
        steps_prof = ENG_PROFILED * 4
        row("svi_meanfield", statistics.median(times), statistics.median(times) / ENG_SVI_STEPS,
            "step",
            profile("svi_meanfield", lambda: ct.svi(*readme, seeds[0], steps=steps_prof,
                                                    device=dev), steps_prof), mb, reads)
        fr = (correlated, (FR_Y,))
        res, ms, mb, reads = _engine_call(lambda: ct.svi(
            *fr, seeds[0], guide="fullrank", steps=ENG_SVI_FR_STEPS, n_mc=16,
            learning_rate=0.02, device=dev))
        a = np.array([[1.0, 1.0], [0.0, 1.0]])
        cov = np.linalg.inv(np.eye(2) + a.T @ a / 0.25)
        mu = cov @ a.T @ np.array(FR_Y) / 0.25
        q_cov = res.covariance_unconstrained().double().cpu().numpy()
        q_mu = res.loc.double().cpu().numpy()
        if not (np.abs(q_mu - mu).max() <= 0.08 and np.abs(q_cov - cov).max() <= 0.05):
            raise AssertionError(f"svi full-rank: loc {q_mu} against {mu}, covariance {q_cov} "
                                 f"against {cov}")
        corr = q_cov[0, 1] / math.sqrt(q_cov[0, 0] * q_cov[1, 1])
        corr_true = cov[0, 1] / math.sqrt(cov[0, 0] * cov[1, 1])
        _within(corr, corr_true, 0.15, "svi full-rank correlation")
        draws = _no_sync(lambda: res.sample(seeds[0], ENG_DRAWS))
        emp = torch.stack([draws["x0"], draws["x1"]], 1).double().cpu().numpy()
        if not np.abs(np.cov(emp.T) - q_cov).max() <= 0.01:
            raise AssertionError("svi full-rank: the draws' covariance is not q's")
        print(f"engines svi full-rank ({ENG_SVI_FR_STEPS} steps): loc {q_mu.round(5).tolist()} "
              f"(exact {mu.round(5).tolist()}), correlation {corr:.4f} (exact {corr_true:.4f})")
        row("svi_fullrank", ms, ms / ENG_SVI_FR_STEPS, "step",
            profile("svi_fullrank", lambda: ct.svi(*fr, seeds[0], guide="fullrank",
                                                   steps=steps_prof, n_mc=16, device=dev),
                    steps_prof), mb, reads)

        # predictive: over the HMC draws, and from the prior
        post = {"mu": hmc_readme.samples["mu"].reshape(-1)}
        (obs_rep, preds), ms, mb, reads = _engine_call(
            lambda: posterior_predictive(*readme, post, seeds[0]))
        y1 = obs_rep["y1"].double()
        _within(float(y1.mean()), README_MEAN, 0.2, "posterior predictive mean")
        _within(float(y1.var()), README_VAR + 4.0, 0.5, "posterior predictive variance")
        row("posterior_predictive", ms, None, "call",
            profile("posterior_predictive", lambda: posterior_predictive(*readme, post, 1), 1),
            mb, reads)
        (lat, obs), ms2, mb2, _ = _engine_call(
            lambda: prior_predictive(readme[0], (0.0, 0.0), ENG_DRAWS, seeds[0], device=dev))
        _within(float(lat["mu"].double().mean()), 1.0, 0.1, "prior predictive mean")
        _within(float(lat["mu"].double().std()), 1.5, 0.1, "prior predictive std")
        _within(float(obs["y1"].double().var()), 1.5 ** 2 + 4.0, 0.4, "prior predictive y var")
        print(f"engines predictive: posterior over {post['mu'].shape[0]} HMC draws, y1 mean "
              f"{float(y1.mean()):.5f}, variance {float(y1.var()):.5f}; prior at {ENG_DRAWS}: "
              f"mu mean {float(lat['mu'].mean()):.5f}, std {float(lat['mu'].std()):.5f}")
        row("prior_predictive", ms2, None, "call",
            profile("prior_predictive", lambda: prior_predictive(
                readme[0], (0.0, 0.0), ENG_DRAWS, 1, device=dev), 1), mb2, 0)

        # the tempered SMC sampler
        det = 6.25 ** 2 - 2.25 ** 2
        quad = (6.25 * (2.0 ** 2 + 3.0 ** 2) - 2 * 2.25 * 2.0 * 3.0) / det
        readme_logz = -0.5 * quad - 0.5 * math.log(det) - math.log(2 * math.pi)
        bb_logz = (math.lgamma(10) + math.lgamma(4) - math.lgamma(14)
                   - (2 * math.lgamma(2) - math.lgamma(4)))
        for name, (model, args), kw, addr, want, tols in (
                ("smc_sampler_readme", readme, dict(n_hmc_moves=3, hmc_step_size=0.5), "mu",
                 (README_MEAN, README_VAR, readme_logz), (0.08, 0.25)),
                ("smc_sampler_waste_free", readme, dict(waste_free=True, chain_length=8,
                                                        hmc_step_size=0.5), "mu",
                 (README_MEAN, README_VAR, readme_logz), (0.08, 0.25)),
                ("smc_sampler_beta_bernoulli", bb, dict(hmc_step_size=0.3), "p",
                 (10.0 / 14.0, None, bb_logz), (0.03, None))):
            calls = [_engine_call(lambda: ct.smc_sampler(model, args, ENG_SMC_N, s, device=dev,
                                                         **kw)) for s in seeds]
            lz = [float(c[0].log_evidence) for c in calls]
            mean_lz, se = statistics.mean(lz), statistics.stdev(lz) / math.sqrt(len(lz))
            _within(mean_lz, want[2], 4 * se + SIS_FLOOR, f"{name} log-evidence")
            m = statistics.mean(float(c[0].samples[addr].double().mean()) for c in calls)
            _within(m, want[0], tols[0], f"{name} mean")
            if want[1] is not None:
                v = statistics.mean(float(c[0].samples[addr].double().var()) for c in calls)
                _within(v, want[1], tols[1], f"{name} variance")
            res, ms, mb, reads = calls[0]
            stages_n = int(res.n_stages)
            print(f"engines {name} n={ENG_SMC_N}: log-evidence {mean_lz:.6f} (SE {se:.6f}, "
                  f"exact {want[2]:.6f}), mean {m:.5f}, {stages_n} stages, accept "
                  f"{float(res.accept_rate):.4f}")
            lik_prior = _split_log_joint(model, args, flatten_model(model, args, dev))
            z = res.positions
            row(name, statistics.median(c[1] for c in calls),
                _grad_ms(lambda q: -(lik_prior[0](q) + lik_prior[1](q)), z), "stage",
                profile(name, lambda: ct.smc_sampler(model, args, ENG_SMC_N, seeds[1],
                                                     device=dev, **kw), stages_n), mb, reads)

        # particle Gibbs on the HMM, the headline observations
        obs = _observations(dev)
        hmm_exact = M.hmm_exact_posterior(obs.cpu().numpy())
        (trajs, log_zs), ms, mb, reads = _engine_call(lambda: ct.particle_gibbs(
            M.hmm_ssm, obs, ENG_PG_N, ENG_PG_ITERS, seeds[0], burn_in=ENG_PG_BURN, device=dev))
        emp = torch.stack([(trajs == k).double().mean(0) for k in range(3)], 1).cpu().numpy()
        err = float(np.abs(emp - hmm_exact).max())
        if not (err <= 0.08 and bool(torch.isfinite(log_zs).all())):
            raise AssertionError(f"particle_gibbs: marginals {err} from forward-backward")
        print(f"engines particle_gibbs N={ENG_PG_N}, {ENG_PG_ITERS} iterations: marginals within "
              f"{err:.4f} of forward-backward, mean log Z {float(log_zs.mean()):.5f}")
        row("particle_gibbs", ms, None, "sweep",
            profile("particle_gibbs", lambda: ct.particle_gibbs(
                M.hmm_ssm, obs, ENG_PG_N, ENG_PROFILED, seeds[1], device=dev), ENG_PROFILED),
            mb, reads)

        # SMC²
        ys, smc2_logz = smc2_data()
        calls = [_engine_call(lambda: smc2(smc2_model, ys, ENG_SMC2_N, ENG_SMC2_N, s, device=dev))
                 for s in seeds]
        lz = [float(c[0].log_evidence) for c in calls]
        mean_lz, se = statistics.mean(lz), statistics.stdev(lz) / math.sqrt(len(lz))
        _within(mean_lz, smc2_logz, 4 * se + SIS_FLOOR, "smc2 log-evidence")
        sig = statistics.mean(float(c[0].mean(lambda th: torch.exp(th["log_sigma"])))
                              for c in calls)
        _within(sig, 1.5, 0.45, "smc2 sigma")
        res, ms, mb, reads = calls[0]
        print(f"engines smc2 {ENG_SMC2_N} x {ENG_SMC2_N}, T={len(ys)}: log-evidence "
              f"{mean_lz:.6f} (SE {se:.6f}, quadrature {smc2_logz:.6f}), sigma {sig:.4f}, "
              f"{int(res.rejuvenations.sum())} rejuvenations, accept {float(res.accept_rate):.4f}")
        row("smc2", statistics.median(c[1] for c in calls), None, "step",
            profile("smc2", lambda: smc2(smc2_model, ys, ENG_SMC2_N, ENG_SMC2_N, seeds[1],
                                         device=dev), len(ys) - 1), mb, reads)
    for name, ms, grad_ms, unit, launches, busy, mb, reads in rows:
        g = "no gradient" if grad_ms is None else f"{grad_ms:.4f} ms a gradient"
        print(f"[{card}] engine {name:27s}: {ms:10.2f} ms a call (synced), {g}, "
              f"{launches:8.1f} launches a {unit}, device busy share {busy:.4f}, "
              f"{mb:.0f} MB at its peak, host reads {reads}")
    print("engines: flatten_model, hmc, chees_hmc, nuts, svi, predictive, smc_sampler, "
          "particle_gibbs and smc2 on the card under sync-debug \"error\" (the counted reads "
          "aside), every gate held")


# --------------------------------------------------------------------------
# slice 7: multi-device execution (parallel_phases)

PAR_SEEDS = 4              # 4 SE + 0.02 over seeds, __graft_entry__.py:57-63
PAR_TIMED = 8              # sweeps timed back to back by CUDA events
PAR_HMM_N = 1 << 20        # the HMM per step, path 4's population
PAR_CSIS_STEPS = 100       # data-parallel training steps on the README Gaussian
PAR_WORLD2_SEEDS = 4       # the gloo pair's LG sweeps a scheme
PAR_WORKER_TIMEOUT = 420   # seconds, each gloo worker


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sharded_sweeps(card, run, seeds, counters, what, exact):
    """``seeds`` sweeps of ``run(seed)`` under sync-debug "error" (the
    counted host reads alone are allowed), the launch counters set to 0
    just before and read just after; logZ against ``exact`` within 4 SE +
    0.02.  Returns (results, launches, host reads a sweep)."""
    from cpprob_tpu_torch.distributions.base import HOST_READS

    run(40_000)
    _sync()
    for c in counters:
        for name in c:
            c[name] = 0
    reads0 = HOST_READS["smc_sharded"]
    results = [_no_sync(lambda s=s: run(s)) for s in range(seeds)]
    launches = {name: v for c in counters for name, v in c.items() if v}
    reads = (HOST_READS["smc_sharded"] - reads0) / seeds
    zs = [float(r.log_evidence) for r in results]
    (mean, se), = _seed_gate(zs, exact, what)
    epochs = [int(r.resampled.sum()) for r in results]
    print(f"[{card}]   {what}: mean logZ={mean:.6f} SE={se:.3g} exact={exact:.6f}; epochs "
          f"{epochs}; launches {launches}; host reads a sweep {reads:.2f}")
    return results, launches, reads


def parallel_phases(card, stages):
    """Slice 7 at world size 1 over NCCL in this process, then at world
    size 2 over gloo, two worker processes sharing the card
    (:func:`parallel_worker`).  Fails on any gate."""
    import subprocess

    import numpy as np
    import torch.distributed as dist

    from cpprob_tpu_torch import CSIS, build_smc_run, sis
    from cpprob_tpu_torch.models import (
        gaussian_unknown_mean_readme,
        hmm_ssm,
    )
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        linear_gaussian_ssm,
        simulate_observations,
    )
    from cpprob_tpu_torch.ops import fused_lg, guided_tc
    from cpprob_tpu_torch.ops.fused_hmm import make_fused_hmm_ssm
    from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels
    from cpprob_tpu_torch.parallel import (
        initialize_multihost,
        particle_mesh,
        sis_sharded,
        smc_sharded,
    )
    from cpprob_tpu_torch.parallel import _collectives as coll
    from cpprob_tpu_torch.util.profiling import env_versions

    print(f"[{card}] parallel: versions {json.dumps(env_versions())}; all-gather call "
          f"torch.distributed.{coll.ALL_GATHER_CALL}")
    dev = torch.device("cuda", 0)
    rows = {}

    def timed(what, sharded, plain, reps=PAR_TIMED):
        ms = time_ms(sharded, reps)
        base = time_ms(plain, reps) if plain is not None else None
        rows[what] = {"ms": ms, "plain_ms": base}
        print(f"[{card}]   {what}: {ms:.4f} ms a sweep by CUDA events"
              + (f", beside {base:.4f} ms single-device (overhead {ms - base:+.4f})"
                 if base is not None else ""))

    with stages.stage("parallel_world1_nccl", sync=True):
        initialize_multihost(f"localhost:{_free_port()}", 1, 0, device="cuda:0")
        try:
            mesh = particle_mesh()
            print(f"[{card}]   mesh {mesh}, backend {dist.get_backend()}")
            one = torch.ones(1, device=dev)        # the communicator's first calls
            coll.psum(one, mesh), coll.pmax(one, mesh), coll.all_gather(one, mesh)
            _sync()

            obs = _lg_obs(dev)
            exact_lg = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
            lg = make_fused_lg_ssm()
            finals = {}
            for scheme in ("balanced", "collective", "island"):
                run = lambda s, scheme=scheme: smc_sharded(
                    lg, obs, LG_N, s, mesh=mesh, chunk=LG_CHUNK, scheme=scheme)
                res, launches, reads = _sharded_sweeps(
                    card, run, PAR_SEEDS, (fused_lg.LAUNCHES,),
                    f"world 1 lg-2^24 chunk {LG_CHUNK} {scheme}", exact_lg)
                _expect(launches, {"chunk": PAR_SEEDS * -(-(LG_T - 1) // LG_CHUNK)},
                        f"world 1 lg {scheme}")
                finals[scheme] = res[0]
                single = build_smc_run(lg, LG_N, chunk=LG_CHUNK)
                timed(f"lg-2^24 {scheme}", lambda run=run: run(7),
                      lambda: single(7, obs))
                rows[f"lg-2^24 {scheme}"].update(reads=reads, launches=launches)
            b, c = finals["balanced"], finals["collective"]
            if not (float(b.log_evidence) == float(c.log_evidence)
                    and torch.equal(b.final_states, c.final_states)):
                raise AssertionError("world 1: balanced differs from collective")
            print(f"[{card}]   balanced == collective bit for bit (seed 0: logZ "
                  f"{float(b.log_evidence)!r}, {LG_N} final states)")
            for scheme in ("balanced", "collective"):
                ops, busy = _device_profile(
                    lambda scheme=scheme: smc_sharded(lg, obs, LG_N, 8, mesh=mesh,
                                                      chunk=LG_CHUNK, scheme=scheme),
                    f"parallel_lg_{scheme}_trace.json", calls=2)
                print(f"[{card}]   lg-2^24 {scheme}: {ops:.1f} device launches a sweep, "
                      f"busy {busy:.4f}")
                rows[f"lg-2^24 {scheme}"].update(device_launches=ops, busy=busy)

            # the guided LG model of path 7 on K12's tensor-core twin
            params = TRAINED_NETS.get("lg") or train_guides(card, stages)[0]
            glg = attach_fused_guided_scalar_kernels(
                linear_gaussian_ssm, params, LG_T, trans_logpdf_elem=guided_trans_lp,
                obs_logpdf_elem=guided_obs_lp)
            run = lambda s: smc_sharded(glg, obs, LG_N, s, mesh=mesh, chunk=LG_CHUNK,
                                        scheme="balanced")
            _, launches, reads = _sharded_sweeps(
                card, run, PAR_SEEDS, (guided_tc.LAUNCHES,),
                f"world 1 guided lg-2^24 chunk {LG_CHUNK} balanced (twin)", exact_lg)
            if not launches.get("guided_tc"):
                raise AssertionError(f"guided sharded sweep: no twin launch {launches}")
            single = build_smc_run(glg, LG_N, chunk=LG_CHUNK)
            timed("guided-lg-2^24 balanced", lambda: run(7), lambda: single(7, obs))
            rows["guided-lg-2^24 balanced"].update(reads=reads, launches=launches)

            # the HMM per step: its model installs only the exchange chunk
            # hooks, which smc_sharded does not take (as the reference)
            try:
                smc_sharded(make_fused_hmm_ssm(), _observations(dev), PAR_HMM_N, 0,
                            mesh=mesh, chunk=CHUNK, scheme="island")
            except ValueError as e:
                print(f"[{card}]   the HMM's chunked sharded sweep refused, as the "
                      f"reference's: {e}")
            else:
                raise AssertionError("smc_sharded took the HMM's exchange chunk hooks")
            hobs = _observations(dev)
            single = build_smc_run(hmm_ssm, PAR_HMM_N)
            for scheme in ("exchange", "island"):
                run = lambda s, scheme=scheme: smc_sharded(hmm_ssm, hobs, PAR_HMM_N, s,
                                                           mesh=mesh, scheme=scheme)
                _, launches, reads = _sharded_sweeps(
                    card, run, PAR_SEEDS, (), f"world 1 hmm-2^20 per step {scheme}",
                    EXACT_LOGZ)
                timed(f"hmm-2^20 per step {scheme}", lambda run=run: run(7),
                      lambda: single(7, hobs))
                rows[f"hmm-2^20 per step {scheme}"].update(reads=reads)

            # sis_sharded on the README Gaussian
            m = gaussian_unknown_mean_readme
            got = [_no_sync(lambda s=s: sis_sharded(m, (3.0, 4.0), SIS_N, s, mesh=mesh))
                   for s in range(PAR_SEEDS)]
            (mu, se_mu), (var, _) = _seed_gate(
                [[float(r.mean("Mean")), float(r.variance("Mean"))] for r in got],
                [2.32353, 1.05882], "sis_sharded README")
            print(f"[{card}]   sis_sharded README 2^20: mean {mu:.5f} (SE {se_mu:.2g}) variance "
                  f"{var:.5f}, against 2.32353 / 1.05882")
            timed("sis README 2^20", lambda: sis_sharded(m, (3.0, 4.0), SIS_N, 7, mesh=mesh),
                  lambda: sis(m, (3.0, 4.0), SIS_N, 7))

            # CSIS: data-parallel training, guided inference over the mesh
            eng = CSIS(m, (0.0, 0.0), embedding_dim=CSIS_E)
            t0 = time.perf_counter()
            params, losses = _no_sync(lambda: eng.compile(
                CHECK_SEED, steps=PAR_CSIS_STEPS, batch_size=CSIS_BATCH, mesh=mesh))
            train_ms = (time.perf_counter() - t0) * 1e3 / PAR_CSIS_STEPS
            losses = losses.cpu()
            first, last = float(losses[:10].mean()), float(losses[-10:].mean())
            if not (np.isfinite(losses.numpy()).all() and last < first):
                raise AssertionError(f"CSIS.compile(mesh=): loss {first} -> {last}")
            t0 = time.perf_counter()
            _no_sync(lambda: eng.compile(CHECK_SEED, steps=PAR_CSIS_STEPS,
                                         batch_size=CSIS_BATCH))
            plain_train_ms = (time.perf_counter() - t0) * 1e3 / PAR_CSIS_STEPS
            print(f"[{card}]   CSIS.compile(mesh=) {PAR_CSIS_STEPS} steps at batch {CSIS_BATCH}: "
                  f"loss {first:.4f} -> {last:.4f}; {train_ms:.3f} ms a step (host "
                  f"clock, synced), single-device {plain_train_ms:.3f}")
            rows["csis compile README"] = {"ms": train_ms, "plain_ms": plain_train_ms}
            got = [_no_sync(lambda s=s: eng.infer(params, (3.0, 4.0), CSIS_N, s, mesh=mesh))
                   for s in range(PAR_SEEDS)]
            (mu, se_mu), = _seed_gate([float(r.mean("Mean")) for r in got], 2.32353,
                                      "CSIS.infer(mesh=) README", floor=0.05)
            ess = float(got[0].ess)
            print(f"[{card}]   CSIS.infer(mesh=) README 2^20: mean {mu:.5f} (SE {se_mu:.2g}), "
                  f"ESS {ess:.0f}")
            timed("csis infer README 2^20",
                  lambda: eng.infer(params, (3.0, 4.0), CSIS_N, 7, mesh=mesh),
                  lambda: eng.infer(params, (3.0, 4.0), CSIS_N, 7))
        finally:
            dist.destroy_process_group()

    # world size 2 over gloo: two processes share the card
    torch.cuda.empty_cache()
    with stages.stage("parallel_world2_gloo", sync=True):
        init = f"tcp://localhost:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker", str(r), "2",
             init], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=PAR_WORKER_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                if line.startswith(f"[{r}]") or line.startswith("dryrun_multichip"):
                    print(f"[{card}]   {line}")
            if p.returncode != 0 or f"[{r}] OK" not in out:
                raise AssertionError(f"gloo worker {r} failed (rc {p.returncode}):\n"
                                     f"{out[-4000:]}")
    print(f"[{card}] parallel: world 1 {stages.totals['parallel_world1_nccl']:.1f} s, "
          f"world 2 {stages.totals['parallel_world2_gloo']:.1f} s")
    print(json.dumps({"parallel": {"card": card, "rows": rows}}))


def parallel_worker(rank, world, init):
    """One rank of the gloo pair sharing the card: ``dryrun_multichip``,
    then the LG sweep at 2^24 in total under balanced and collective, the
    rank's own K7 chunk against its plain version, distinct Philox streams
    across ranks, and the bytes an epoch sends."""
    import numpy as np
    import torch.distributed as dist

    from cpprob_tpu_torch.entry import dryrun_multichip
    from cpprob_tpu_torch.models.linear_gaussian import (
        kalman_filter_1d,
        simulate_observations,
    )
    from cpprob_tpu_torch.ops import fused_lg
    from cpprob_tpu_torch.ops.fused_lg import lg_chunk, lg_chunk_plain, make_fused_lg_ssm
    from cpprob_tpu_torch.parallel import initialize_multihost, particle_mesh, smc_sharded
    from cpprob_tpu_torch.parallel import _collectives as coll
    from cpprob_tpu_torch.util.seeds import derive_seed
    from cpprob_tpu_torch.parallel.resampling import (
        balanced_systematic_resample,
        ring_systematic_resample,
    )
    from cpprob_tpu_torch.parallel.smc import _MOVE_TAG

    initialize_multihost(init, world, rank, device="cuda:0", backend="gloo",
                         timeout=PAR_WORKER_TIMEOUT / 2)
    try:
        mesh = particle_mesh(world)
        dev = torch.device("cuda", 0)
        print(f"[{rank}] backend {dist.get_backend()} on {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        dryrun_multichip(world)
        print(f"[{rank}] dryrun_multichip({world}) passed in "
              f"{time.perf_counter() - t0:.2f} s")

        obs = _lg_obs(dev)
        exact = kalman_filter_1d(simulate_observations(LG_T, 0))[2]
        lg = make_fused_lg_ssm()
        n_local = LG_N // world
        finals = {}
        for scheme in ("balanced", "collective"):
            fused_lg.LAUNCHES["chunk"] = 0
            res = [smc_sharded(lg, obs, LG_N, s, mesh=mesh, chunk=LG_CHUNK, scheme=scheme)
                   for s in range(PAR_WORLD2_SEEDS)]
            zs = [float(r.log_evidence) for r in res]
            (mean, se), = _seed_gate(zs, exact, f"gloo world {world} {scheme}")
            finals[scheme] = res[0]
            launches = fused_lg.LAUNCHES["chunk"]
            ms = time_ms(lambda scheme=scheme: smc_sharded(
                lg, obs, LG_N, 7, mesh=mesh, chunk=LG_CHUNK, scheme=scheme), 4)
            print(f"[{rank}] lg-2^24 world {world} {scheme}: mean logZ {mean:.6f} SE "
                  f"{se:.3g} (Kalman {exact:.6f}); epochs "
                  f"{[int(r.resampled.sum()) for r in res]}; K7 launches {launches}; "
                  f"{ms:.3f} ms a sweep by CUDA events")
        b, c = finals["balanced"], finals["collective"]
        same = int(float(b.log_evidence) == float(c.log_evidence)
                   and torch.equal(b.final_states, c.final_states))
        if int(coll.psum(torch.tensor([float(same)], device=dev), mesh)) != world:
            raise AssertionError("balanced differs from collective across the ranks")
        print(f"[{rank}] balanced == collective bit for bit on every rank (logZ "
              f"{float(b.log_evidence)!r}, {n_local} states here)")

        # this rank's K7 chunk against its plain version, with its own seed
        seed = derive_seed(0, _MOVE_TAG, rank)
        x0, w0 = _lg_population(n_local, CHECK_SEED, obs)    # the same on both ranks
        ys, valid = _lg_chunks(obs)
        xk, wk, _ = lg_chunk(seed, x0, w0, ys[0], valid[0], t0=1)
        xp, wp, _ = lg_chunk_plain(seed, x0, w0, ys[0], valid[0], t0=1)
        torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5)
        err = float((wk - wp).abs().max())
        firsts = coll.all_gather(xk[:4096], mesh)
        if torch.equal(firsts[0], firsts[1]):
            raise AssertionError("two ranks drew the same first chunk")
        print(f"[{rank}] K7 with this rank's seed {seed} against its plain version: "
              f"max |dlog_w| {err:.3g}; the ranks' first chunks differ")

        # the bytes an epoch sends, at the sweep's shapes
        lw = wk.clone()
        for name, fn in (("balanced", balanced_systematic_resample),
                         ("ring", ring_systematic_resample)):
            before = dict(coll.BYTES_SENT)
            fn(0.37, lw, xk, mesh)
            sent = {k: coll.BYTES_SENT[k] - before[k] for k in before}
            print(f"[{rank}] {name} epoch at n_local={n_local}: sends {sent} bytes")
        print(f"[{rank}] OK")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# slice 8: the CLI, the SHERPA models, the external-simulator bridge and the
# example drivers on the card

DRV_SIS_N = 1 << 20        # the JAX README's headline call, rounded up
DRV_SMC_N = 1 << 20
DRV_SEEDS = 4              # 4 SE + 0.02 over seeds, __graft_entry__.py:57-63
DRV_CSIS_STEPS = 100
DRV_CSIS_BATCH = 256
DRV_CSIS_N = 1 << 18       # its text dump is written and parsed on the host
DRV_HMM_OBS = "[0.9 0.8 0.7 0.0 -0.025 -5.0 -2.0 -0.1 0.0 0.13]"   # README.md's
DRV_SHERPA_STEPS = 300     # the example's; cut here first if the phase outgrows ~150 s
DRV_SHERPA_TIMED = 8       # infer calls timed back to back by CUDA events
DRV_KB_N = 20              # the kernel_bench twin's --n
DRV_ESTIMATE_TOL = 1e-4    # estimate's printed means against the dump's (float32 sums)


def _cli(argv):
    """``cli.main(argv + --device cuda)``: (exit code, stdout, host ms)."""
    import contextlib
    import io

    from cpprob_tpu_torch import cli

    buf = io.StringIO()
    _sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--device", "cuda"])
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}\n{out[-2000:]}")
    return out, ms


def _after(out, label):
    return float(out.split(label)[-1].split()[0])


def _state_means(out):
    """The ``Mean: [...]`` vector that ``StatsPrinter`` prints under
    ``State:``."""
    import numpy as np

    block = out.split("State:")[1].split("Mean:")[1]
    return np.array(block.split("[", 1)[1].split("]", 1)[0].split(), np.float64)


def driver_phases(card, stages):
    """Slice 8 on the card: ``cli.main`` (``sis`` on the README Gaussian at
    2^20, ``smc`` on the HMM at 2^20 over 4 seeds, ``compile`` then ``csis``
    on the HMM with its checkpoint and posterior dump in a fresh
    directory, ``estimate`` on the dump), the ``sherpa_fullscale`` twin at
    the full 35x35x20 volume with 4,096 deposits and its gate, the
    ``external_simulator`` twin in full mode with its gates, and the
    ``kernel_bench`` twin at 2^20 with its paths' launches counted.  Every
    value is gated against its exact value; nothing is caught."""
    import argparse
    import shutil
    import tempfile

    import numpy as np

    from cpprob_tpu_torch.distributions.base import HOST_READS
    from cpprob_tpu_torch.examples import external_simulator, kernel_bench, sherpa_fullscale
    from cpprob_tpu_torch.io import load_posterior
    from cpprob_tpu_torch.models import hmm_exact_posterior, hmm_log_evidence

    rows = {}
    hmm_obs = np.array([float(x) for x in DRV_HMM_OBS.strip("[]").split()], np.float32)

    # the CLI, in this process, on the card
    with stages.stage("driver_cli", sync=True):
        times = []
        for _ in range(2):          # the process's first vmapped call, then a warm one
            out, ms = _cli(["--model", "gaussian", "-m", "sis", "-n", str(DRV_SIS_N),
                            "-o", "3.0 4.0", "--seed", "1"])
            times.append(ms)
        mean, var, ess = _after(out, "Mean:"), _after(out, "Variance:"), _after(out, "ESS:")
        tol = 4 * math.sqrt(var / ess) + 0.002
        print(f"[{card}] driver cli sis gaussian {DRV_SIS_N}: mean {mean:.5f} variance "
              f"{var:.5f} ESS {ess:.0f}; {times[0]:.1f} ms the first call of the process, "
              f"{times[1]:.1f} ms the next (host clock, with the CLI's set-up); against "
              f"2.32353 / 1.05882, tol {tol:.4f}")
        _within(mean, 2.32353, tol, "cli sis mean")
        _within(var, 1.05882, 0.02, "cli sis variance")
        rows["cli_sis"] = {"first_ms": times[0], "ms": times[1], "mean": mean, "ess": ess}

        zs, times = [], []
        for s in range(DRV_SEEDS):
            out, ms = _cli(["--model", "hmm", "-m", "smc", "-n", str(DRV_SMC_N),
                            "-o", DRV_HMM_OBS, "--seed", str(s)])
            zs.append(_after(out, "log_evidence:"))
            times.append(ms)
        exact = hmm_log_evidence(hmm_obs)
        ((z, se),) = _seed_gate(zs, exact, "cli smc hmm")
        print(f"[{card}] driver cli smc hmm {DRV_SMC_N}: logZ {z:.5f} (SE {se:.2g}) against "
              f"{exact:.5f}; {statistics.median(times):.1f} ms a call (host clock)")
        rows["cli_smc"] = {"ms": statistics.median(times), "log_evidence": z, "se": se}

        d = tempfile.mkdtemp(prefix="cpprob_cli_")
        try:
            ckpt, post = os.path.join(d, "nn"), os.path.join(d, "post")
            _, ms_compile = _cli(["--model", "hmm", "-m", "compile", "--steps",
                                  str(DRV_CSIS_STEPS), "--batch-size", str(DRV_CSIS_BATCH),
                                  "--ckpt-dir", ckpt])
            out, ms_csis = _cli(["--model", "hmm", "-m", "csis", "-n", str(DRV_CSIS_N),
                                 "-o", DRV_HMM_OBS, "--ckpt-dir", ckpt, "--dump-path", post])
            out_est, ms_est = _cli(["--model", "hmm", "-m", "estimate", "--dump-path", post])
            predicts, lw = load_posterior(post)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        states = np.asarray(predicts["State"])
        lw = np.asarray(lw, np.float64)
        w = np.exp(lw - lw.max())
        w /= w.sum()
        est = np.stack([(w[:, None] * (states == k)).sum(0) for k in range(3)], 1)
        exact_post = hmm_exact_posterior(hmm_obs)
        err = float(np.abs(est - exact_post).max())
        # what `estimate` printed: State's weighted mean a step, held to the
        # dump's own weighted mean (the parse, weighting and reduction) and
        # to forward-backward's
        printed = _state_means(out_est)
        exact_means = np.asarray(exact_post) @ np.arange(3.0)
        parse_err = float(np.abs(printed - est @ np.arange(3.0)).max())
        mean_err = float(np.abs(printed - exact_means).max())
        print(f"[{card}] driver cli estimate: State means {np.round(printed, 4).tolist()}, "
              f"within {parse_err:.2g} of the dump's weighted means and {mean_err:.4f} of "
              f"forward-backward's")
        if not parse_err <= DRV_ESTIMATE_TOL:
            raise AssertionError(f"cli estimate: State means {printed} are {parse_err} from "
                                 f"the dump's")
        if not mean_err <= SIS_MARGINAL_TOL:
            raise AssertionError(f"cli estimate: State means {printed} are {mean_err} from "
                                 f"forward-backward's {exact_means}")
        print(f"[{card}] driver cli compile hmm {DRV_CSIS_STEPS} steps at batch "
              f"{DRV_CSIS_BATCH}: {ms_compile:.1f} ms; csis {DRV_CSIS_N}: {ms_csis:.1f} ms, ESS "
              f"{1 / float(np.sum(w * w)):.0f}, marginals within {err:.4f} of "
              f"forward-backward; estimate on the dump {ms_est:.1f} ms (host clock)")
        if not err <= SIS_MARGINAL_TOL:
            raise AssertionError(f"cli csis marginals {err} from forward-backward")
        rows["cli_csis"] = {"compile_ms": ms_compile, "csis_ms": ms_csis,
                            "estimate_ms": ms_est, "marginal_err": err,
                            "estimate_mean_err": mean_err}

    # the slice's full-width path: CNN3D-guided CSIS on the full calorimeter
    with stages.stage("driver_sherpa", sync=True):
        args = sherpa_fullscale.build_parser().parse_args(
            ["--steps", str(DRV_SHERPA_STEPS), "--device", "cuda"])
        payload, eng, params, observed_for = sherpa_fullscale.run(args)
        if payload["volume"] != [35, 35, 20] or payload["max_deposits"] != 4096:
            raise AssertionError(f"sherpa: volume {payload['volume']}")
        obs = observed_for(2)
        call = lambda: eng.infer(params, (obs, 10.0), args.particles, 5, defensive=0.3)
        infer_ms = time_ms(call, DRV_SHERPA_TIMED)
        launches, busy = _device_profile(call, "driver_sherpa_infer_trace.json")
        tr = payload["train"]
        print(f"[{card}] driver sherpa_fullscale 35x35x20, 4,096 deposits: "
              f"{tr['steps']} steps at batch {tr['batch_size']} in {tr['wall_s']:.2f} s = "
              f"{tr['traces_per_sec']:.1f} traces/s, loss {tr['loss_first']:.1f} -> "
              f"{tr['loss_last']:.1f}; infer at {args.particles}: {infer_ms:.4f} ms by CUDA "
              f"events ({payload['infer_ms']['median']:.2f} ms host clock with its reads), "
              f"{launches:.0f} launches a call, busy {busy:.4f}; peak memory "
              f"{payload['peak_memory_bytes'] / 2**20:.0f} MB; operating point "
              f"{json.dumps(payload['operating_point'])}")
        rows["sherpa"] = {"traces_per_sec": tr["traces_per_sec"], "infer_ms": infer_ms,
                          "infer_host_ms": payload["infer_ms"]["median"],
                          "launches": launches, "busy": busy,
                          "peak_memory_mb": payload["peak_memory_bytes"] / 2**20,
                          "operating_point": payload["operating_point"]}
        del eng, params

    # the external simulator in the loop, full mode (its gates assert)
    with stages.stage("driver_external", sync=True):
        reads0 = HOST_READS["observe_external"]
        rec = external_simulator.main(["--device", "cuda"])
        if not rec["gates_enforced"]:
            raise AssertionError("external_simulator: gates not enforced")
        call = rec["guided_call"]
        print(f"[{card}] driver external_simulator full mode: ESS ratio "
              f"{rec['ess_ratio_guided_over_prior']:.2f}, energy error vs the large prior "
              f"SIS {rec['energy_abs_err_guided_vs_reference_posterior']:.2f}, vs truth "
              f"{rec['energy_abs_err_guided_vs_truth']:.2f}; a guided call at "
              f"{rec['n_particles']}: {call['exchanges']} exchanges, {call['host_reads']} "
              f"host reads, {call['ms_median']:.1f} ms (host clock); "
              f"{HOST_READS['observe_external'] - reads0} reads in the run; particles/s "
              f"{json.dumps(rec['throughput_particles_per_s'])}")
        if call["exchanges"] != 2 or call["host_reads"] != 2:
            raise AssertionError(f"external: a guided call made {call}")
        rows["external"] = {**call, "ess_ratio": rec["ess_ratio_guided_over_prior"],
                            "throughput": rec["throughput_particles_per_s"]}

    # the kernel_bench twin: its six paths' kernels, counted on their sweeps
    with stages.stage("driver_kernel_bench", sync=True):
        rec = kernel_bench.main(["--n", str(DRV_KB_N), "--device", "cuda"])
        epoch = ("stream_resample.lse_stats", "stream_resample.pass1",
                 "stream_resample.pass2")
        want = {"discrete_5state_spec_kernel": ("fused_hmm.init", "fused_hmm.chunk"),
                "linear_gaussian_live_resampling": ("user_chunk.scalar",) + epoch,
                "linear_gaussian_per_step": ("fused_lg.init", "fused_lg.step_ctrl")
                + epoch,
                "linear_gaussian_guided_fused": ("guided_tc.guided_tc",) + epoch,
                "discrete_5state_guided_fused": ("fused_hmm.init", "fused_hmm.guided_chunk",
                                                 "fused_hmm.guided_tables")}
        for path, names in want.items():
            r = rec[path]
            exact = r.get("exact_log_evidence", r.get("kalman_log_evidence"))
            se = r["log_evidence_std"] / math.sqrt(r["sweeps"] - 1)
            print(f"[{card}] driver kernel_bench 2^{DRV_KB_N} {path}: "
                  f"{r['sweep_s'] * 1e3:.4f} ms a sweep (host clock), logZ "
                  f"{r['log_evidence_mean']:.5f} (SE {se:.2g}) against {exact:.5f}; "
                  f"launches {r['launches']}")
            _within(r["log_evidence_mean"], exact, 4 * se + 0.02, f"kernel_bench {path}")
            missing = [k for k in names if not r["launches"].get(k)]
            if missing:
                raise AssertionError(f"kernel_bench {path}: no launch of {missing}")
        ep = rec["resample_epoch"]
        print(f"[{card}] driver kernel_bench epoch at 2^{DRV_KB_N}: streaming "
              f"{ep['streaming_pallas_s'] * 1e3:.4f} ms, sorted fill "
              f"{ep['xla_sorted_fill_s'] * 1e3:.4f} ms (host clock, synced)")
        rows["kernel_bench"] = {k: {"sweep_ms": rec[k]["sweep_s"] * 1e3,
                                    "launches": rec[k]["launches"]} for k in want}
        rows["kernel_bench"]["epoch_ms"] = {"streaming": ep["streaming_pallas_s"] * 1e3,
                                            "sorted_fill": ep["xla_sorted_fill_s"] * 1e3}
    path = os.path.join(REPO, "chiprun_out", "driver.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": card, **rows}, f, indent=1, default=str)
    return rows


# ---------------------------------------------------------------------------
# the roofline: K17-K21, the card's calibration

CAL_CHECK_N = 1 << 20      # the calibrations' checks against the plain versions
CAL_PRNG_CHECK_N = 1 << 16
CAL_PRNG_CHECK_DRAWS = 64
CAL_TC_CHECK_ROWS = 4096
CAL_TC_CHECK_REPS = 8
# K20a against its plain version: within 1e-4 on the sum before its 1e-9
# scale (the precise logf / sincosf against torch's may differ in the last
# bit; the pairs are summed in the same order); K21 within 1e-6 (a
# contracting map); K18 relative to the norm within 2^-8 per product (bf16
# operands rounded alike, float32 sums in another order); K17, K19 and
# K20b exactly
NORMALS_TOL = 1e-4 * 1e-9
TRANS_TOL = 1e-6


def check_calibrations():
    """K17-K21 against their plain versions on the card at reduced sizes
    (the plain Philox is slow).  Returns the largest error of each."""
    import numpy as np

    from cpprob_tpu_torch.ops import calibrate as cal

    dev = torch.device("cuda")
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.0, CAL_CHECK_N)
                        .astype(np.float32), device=dev)
    errs = {}
    for key, k, p in (("fp32", cal.calibrate_fp32(x), cal.calibrate_fp32_plain(x)),
                      ("hbm", cal.calibrate_hbm(x), cal.calibrate_hbm_plain(x))):
        _sync()
        n_bad = int((k != p).sum())
        print(f"check {key} n={CAL_CHECK_N}: {n_bad} elements differ from the plain version")
        if n_bad:
            raise AssertionError(f"calibration {key}: kernel and plain version differ")
        errs[key] = 0.0
    k, p = cal.calibrate_transcendental(x), cal.calibrate_transcendental_plain(x)
    _sync()
    errs["transcendental"] = float((k - p).abs().max())
    print(f"check transcendental n={CAL_CHECK_N} chain={cal.TRANS_CHAIN}: max|d|="
          f"{errs['transcendental']:.3g} (tolerance {TRANS_TOL}), bit-equal "
          f"{torch.equal(k, p)}")
    if errs["transcendental"] > TRANS_TOL:
        raise AssertionError("calibration transcendental: outside its tolerance")
    xp = x[:CAL_PRNG_CHECK_N].contiguous()
    pairs = CAL_PRNG_CHECK_DRAWS // 2
    k, p = cal.calibrate_normals(3, xp, pairs), cal.calibrate_normals_plain(3, xp, pairs)
    _sync()
    errs["normals"] = float((k - p).abs().max())
    print(f"check normals n={CAL_PRNG_CHECK_N} pairs={pairs}: max|d|="
          f"{errs['normals']:.3g} (tolerance {NORMALS_TOL:.0e}), bit-equal {torch.equal(k, p)}")
    if errs["normals"] > NORMALS_TOL:
        raise AssertionError("calibration normals: outside its tolerance")
    k = cal.calibrate_philox(3, xp, CAL_PRNG_CHECK_DRAWS)
    p = cal.calibrate_philox_plain(3, xp, CAL_PRNG_CHECK_DRAWS)
    _sync()
    if not torch.equal(k, p):
        raise AssertionError("calibration philox: kernel and plain version differ")
    errs["philox"] = 0.0
    print(f"check philox n={CAL_PRNG_CHECK_N} calls={CAL_PRNG_CHECK_DRAWS}: equal")
    a, b = (torch.as_tensor(t, device=dev)
            for t in cal.tensor_core_operands(CAL_TC_CHECK_ROWS, seed=1))
    k = cal.calibrate_tensor_cores(a, b, CAL_TC_CHECK_REPS)
    p = cal.calibrate_tensor_cores_plain(a, b, CAL_TC_CHECK_REPS)
    _sync()
    rel = float((k - p).norm() / p.norm())
    errs["tensor_cores"] = float((k - p).abs().max())
    print(f"check tensor_cores rows={CAL_TC_CHECK_ROWS} reps={CAL_TC_CHECK_REPS}: "
          f"relative norm error {rel:.3g} (tolerance {CAL_TC_CHECK_REPS * 2.0 ** -8:.3g}), "
          f"max|d|={errs['tensor_cores']:.3g} of max|p|={float(p.abs().max()):.3g}, "
          f"{int((k != p).sum())} of {p.numel()} elements not bit-equal")
    if not rel < CAL_TC_CHECK_REPS * 2.0 ** -8:
        raise AssertionError("calibration tensor_cores: outside its tolerance")
    return errs


def roofline_phases(card, stages):
    """The card's calibration: K17-K21 against their plain versions, then
    ``util/roofline.py``'s ``calibrate_peaks`` at the reference's sizes with
    the launch counts set to 0 just before and read just after; the plain
    versions' times.  Returns (kernel lines, peaks)."""
    from cpprob_tpu_torch.ops import calibrate as cal
    from cpprob_tpu_torch.util import roofline as rl

    with stages.stage("calibration_vs_plain", sync=True):
        errs = check_calibrations()
    for k in cal.LAUNCHES:
        cal.LAUNCHES[k] = 0
    with stages.stage("calibration", sync=True):
        peaks, runs = rl.calibrate_peaks()
    launches = dict(cal.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"calibration: a kernel never launched: {launches}")
    datasheet = {"fp32_flops_per_s": rl.F32_OPS_PER_S,
                 "tensor_core_bf16_macs_per_s": rl.TC_BF16_MACS_PER_S,
                 "hbm_marginal_bytes_per_s": rl.HBM_BYTES_PER_S}
    for key, v in peaks.items():
        if isinstance(v, float):
            print(f"[{card}] {key:30s} {v:.6g}"
                  + (f"  ({v / datasheet[key]:.4f} of the datasheet's)"
                     if key in datasheet else ""))
    for key in ("fp32_flops_per_s", "tensor_core_bf16_macs_per_s",
                "hbm_marginal_bytes_per_s", "philox_calls_per_s",
                "normal_variates_per_s", "exp_log1p_pairs_per_s"):
        if not 0 < peaks[key] < datasheet.get(key, math.inf):
            raise AssertionError(f"calibration: {key} = {peaks[key]} is not a "
                                 "positive rate below the datasheet's")
    if not peaks["launch_fixed_s"] >= 0:
        raise AssertionError("calibration: negative fixed cost of a launch")
    print(f"[{card}] K19 at the two sizes: {runs['hbm']['ms_small']:.4f} ms "
          f"(128 MB moved), {runs['hbm']['ms']:.4f} ms (512 MB); torch.add "
          f"{runs['hbm']['library_ms']:.4f} ms; K18 against torch.matmul bf16 "
          f"(4096x8192 @ 8192x4096, the same multiply-adds) "
          f"{runs['tensor_cores']['library_ms']:.4f} ms")

    # the plain versions on the same inputs, timed once each
    seed = 0
    xf, = runs["fp32"]["inputs"]
    a, b = runs["tensor_cores"]["inputs"]
    xh, = runs["hbm"]["inputs"]
    xp, = runs["normals"]["inputs"]
    xt, = runs["transcendental"]["inputs"]
    plain = {
        "fp32": lambda: cal.calibrate_fp32_plain(xf),
        "tensor_cores": lambda: cal.calibrate_tensor_cores_plain(a, b),
        "hbm": lambda: cal.calibrate_hbm_plain(xh),
        "normals": lambda: cal.calibrate_normals_plain(seed, xp, cal.PRNG_DRAWS // 2),
        "philox": lambda: cal.calibrate_philox_plain(seed, xp, cal.PRNG_DRAWS),
        "transcendental": lambda: cal.calibrate_transcendental_plain(xt),
    }
    with stages.stage("calibration_plain", sync=True):
        plain_ms = {key: time_ms(fn, 1) for key, fn in plain.items()}
    entries = rl.calibration_entries(runs, launches)
    for e, key in zip(entries, rl.CALIBRATIONS):
        e["max_abs_err"] = errs[key]
        e["plain_ms"] = plain_ms[key]
        print(f"[{card}] {e['name']}: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, launches {e['launches']}")
    return entries, peaks


def roofline_line(card, peaks, kernels):
    """The calibrated bounds of every kernel line (``analyze_kernels``);
    prints the ``roofline`` JSON line and writes the whole analysis to
    chiprun_out/roofline.json.  Fails on a fraction above 1."""
    from cpprob_tpu_torch.util import roofline as rl

    rates = rl.analyze_kernels(peaks, kernels)
    outran = rl.uncalibrated_setters(rates)
    if outran:
        raise AssertionError(f"kernels faster than a calibrated rate at their "
                             f"counts (a wrong count?), by resource: {outran}")
    for k in kernels:
        if not 0 < k["calibrated_fraction"] <= 1.0 + 1e-9:
            raise AssertionError(f"{k['name']}: calibrated fraction "
                                 f"{k['calibrated_fraction']}")
        print(f"  roofline {k['name'][:58]:58s} {k['ms']:9.4f} ms  bound "
              f"{k['bound_ms']:8.4f} ({k['bound_by'][:5]})  calibrated "
              f"{k['calibrated_bound_ms']:8.4f} ({k['calibrated_by']}) "
              f"fraction {k['calibrated_fraction']:.4f}")
    summary = {"card": card, "peaks": peaks, "rates": rates, "kernels": [
        {key: k[key] for key in ("name", "ms", "launches", "bound_ms", "bound_by",
                                 "calibrated_bound_ms", "calibrated_by",
                                 "calibrated_fraction")} for k in kernels]}
    out = os.path.join(REPO, "chiprun_out", "roofline.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({**summary, "kernels": kernels}, f, indent=1)
        f.write("\n")
    print(json.dumps({"roofline": summary}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        sys.exit(1)
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
    check_sass()
    kernels = (hmm_phases(card, stages) + lg_phases(card, stages)
               + spec_phases(card, stages) + user_phases(card, stages)
               + guided_phases(card, stages) + r1_phases(card, stages))
    replay_phases(card, stages)
    distribution_phases(card, stages)
    sis_phases(card, stages)
    csis_phases(card, stages)
    engine_phases(card, stages)
    parallel_phases(card, stages)
    driver_phases(card, stages)
    calibrations, peaks = roofline_phases(card, stages)
    kernels += calibrations
    print(stages.report())
    roofline_line(card, peaks, kernels + ROOFLINE_EXTRA)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "calibrated_bound_ms", "calibrated_by")
    missing = [(k["name"], key) for k in kernels for key in keys if key not in k]
    if missing or len(kernels) != 29:
        raise AssertionError(f"kernels line: {len(kernels)} entries, missing {missing}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device for the parallel worker")
        parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
