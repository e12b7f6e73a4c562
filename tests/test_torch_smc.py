"""The port's SMC slice (``cpprob_tpu_torch``) against the JAX package.

Resampling functions and the chunk-boundary glue are compared with the
reference's on the same numpy-made inputs; the whole slice runs on the CPU
through the kernels' plain versions and is held to the exact forward
recursion and to the JAX package's own estimate, within 4 SE + 0.02 (the
rule of ``__graft_entry__.py``).
"""

import dataclasses
import functools
import importlib
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference import resampling as ref_rs
from cpprob_tpu.ops.pallas_ssm import discrete_hmm_log_evidence
from cpprob_tpu_torch import build_smc_run, smc
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.inference.smc import make_smc_step_exchange_fused_chunked
from cpprob_tpu_torch.interop import carry_from_numpy
from cpprob_tpu_torch.ops.fused_hmm import (
    ISLAND_SIZE,
    hmm_chunk_plain,
    make_fused_hmm_ssm,
    stats_from_partials,
)

# the packages' ``hmm`` and ``smc`` attributes are functions, not the modules
ref_hmm = importlib.import_module("cpprob_tpu.models.hmm")
ref_smc = importlib.import_module("cpprob_tpu.inference.smc")
port_hmm = importlib.import_module("cpprob_tpu_torch.models.hmm")
port_smc = importlib.import_module("cpprob_tpu_torch.inference.smc")

torch.set_num_threads(2)

N = 1 << 14
SEEDS = 8
FLOOR = 0.02
OBS = port_hmm.simulate_observations(16, 0)      # the headline benchmark's
EXACT = -26.44222


def _mean_se(vals):
    vals = np.asarray(vals, np.float64)
    return vals.mean(), vals.std(ddof=1) / math.sqrt(len(vals))


def _population(seed, n, spread):
    rng = np.random.RandomState(seed)
    states = rng.randint(0, 3, n).astype(np.int32)
    log_w = (spread * rng.normal(size=n)).astype(np.float32)
    return states, log_w


@pytest.mark.parametrize("spread", [0.1, 3.0])
def test_resampling_functions_match_reference(spread):
    states, log_w = _population(1, 4096, spread)
    lw_t = torch.as_tensor(log_w)
    np.testing.assert_allclose(float(rs.ess(lw_t)), float(ref_rs.ess(log_w)),
                               rtol=1e-6)
    cw = rs.category_weights(lw_t, torch.as_tensor(states), 3).numpy()
    cw_ref = np.array(ref_rs.category_weights(log_w, states, 3))
    np.testing.assert_allclose(cw, cw_ref, rtol=1e-6, atol=1e-7)
    for u0 in (0.0, 0.3, 0.999):
        counts = rs.category_counts_systematic(u0, torch.as_tensor(cw_ref), 4096)
        counts_ref = ref_rs.category_counts_systematic(u0, cw_ref, 4096)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_ref))
        np.testing.assert_array_equal(
            rs.states_from_counts(counts, 4096).numpy(),
            np.asarray(ref_rs.states_from_counts(counts_ref, 4096)))


def test_systematic_resample_matches_reference_ancestors():
    _, log_w = _population(2, 256, 1.5)
    gen = torch.Generator().manual_seed(11)
    u0 = float(torch.rand((), generator=torch.Generator().manual_seed(11),
                          dtype=torch.float64))
    anc = rs.systematic_resample(gen, torch.as_tensor(log_w))
    cdf = ref_rs._normalized_cumsum(jnp.asarray(log_w))
    anc_ref = ref_rs.systematic_ancestors_from_cdf(cdf, jnp.float32(u0), 256)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_ref))


def test_resampler_names():
    assert rs.get_resampler("systematic") is rs.systematic_resample
    assert rs.get_resampler("stratified") is rs.stratified_resample
    assert rs.get_resampler("multinomial") is rs.multinomial_resample
    assert rs.get_resampler("residual") is rs.residual_resample
    for name in ("bogus", "Systematic"):
        with pytest.raises(ValueError):
            rs.get_resampler(name)


@pytest.mark.parametrize("spread,hook", [
    (0.1, "fused_chunk_exchange_t_batch"), (3.0, "fused_chunk_exchange_t_batch")])
def test_chunk_glue_step_matches_reference(spread, hook):
    n = 1 << 12
    states, log_w = _population(3, n, spread)
    log_z = -1.25
    ess = float(ref_rs.ess(log_w))
    cat_w = np.array(ref_rs.category_weights(log_w, states, 3))
    lme = float(jax.scipy.special.logsumexp(log_w) - np.log(n))
    ys = np.linspace(-1, 1, 16).astype(np.float32)
    seen = {}

    def capture_ref(key, s, w, ys_, n_valid, flag, ticks):
        seen["ref"] = (int(flag), np.asarray(ticks))
        return s, w, jnp.float32(n), jnp.ones(3) / 3, jnp.float32(0.0)

    def capture_port(key, s, w, ys_, n_valid, flag, ticks, t0):
        assert t0 == 1
        seen["port"] = (int(flag), ticks.numpy())
        return s, w, torch.tensor(float(n)), torch.ones(3) / 3, torch.tensor(0.0)

    key = jax.random.key(4)
    ref_model = dataclasses.replace(ref_hmm.hmm_ssm,
                                    fused_chunk_exchange_batch=capture_ref)
    ref_step = ref_smc.make_smc_step_exchange_fused_chunked(ref_model, n, 0.5)
    carry = (key, jnp.asarray(states), jnp.asarray(log_w), jnp.float32(log_z),
             jnp.float32(ess), jnp.asarray(cat_w), jnp.float32(lme))
    (_, _, _, log_z_ref, *_), (do_ref,) = ref_step(carry, (jnp.asarray(ys), jnp.int32(15)))
    u0 = float(jax.random.uniform(jax.random.split(key, 3)[1], ()))

    port_model = dataclasses.replace(port_hmm.hmm_ssm, **{hook: capture_port})
    step = make_smc_step_exchange_fused_chunked(port_model, n, 0.5)
    carry = carry_from_numpy(4, states, log_w, log_z, ess, cat_w, lme, device="cpu")
    (_, _, _, log_z_port, *_), (do_port,) = step(
        carry, (torch.as_tensor(ys), torch.tensor(15, dtype=torch.int32), 1), u0=u0)

    assert bool(do_port) == bool(do_ref) == (spread > 1.0)
    assert seen["port"][0] == seen["ref"][0]
    assert np.abs(seen["port"][1].astype(np.int64) - seen["ref"][1]).max() <= 1
    np.testing.assert_allclose(float(log_z_port), float(log_z_ref), atol=1e-6)


@functools.lru_cache(maxsize=1)
def _ref_logz_stats():
    run = jax.jit(ref_smc.build_smc_run(ref_hmm.hmm_ssm, N))
    obs = jnp.asarray(OBS)
    return _mean_se([float(run(jax.random.key(100 + i), obs).log_evidence)
                     for i in range(SEEDS)])


@pytest.mark.parametrize("chunk", [16, 4])
def test_fused_slice_matches_exact_and_reference(chunk):
    """chunk=16 is the main path (one launch, interior check at t=7);
    chunk=4 runs four launches with a ragged tail (valid 4, 4, 4, 3) and
    resamples at chunk boundaries through the flag and ticks."""
    island_counts = []
    model = make_fused_hmm_ssm(island_every=8, island_counts=island_counts)
    run = build_smc_run(model, N, chunk=chunk)
    obs = torch.as_tensor(OBS)
    results = [run(i, obs) for i in range(SEEDS)]
    n_chunks = -(-15 // chunk)
    assert len(island_counts) == SEEDS * n_chunks
    assert all(c.shape == (N // ISLAND_SIZE,) for c in island_counts)
    if chunk == 16:      # the interior check at t = 7 fires on these observations
        assert float(torch.stack(island_counts).mean()) > 0
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    assert abs(mean - EXACT) < 4 * se + FLOOR, (mean, se)
    assert abs(mean - port_hmm.hmm_log_evidence(OBS)) < 4 * se + FLOOR
    for r in results:
        assert r.final_states.shape == (N,) and r.final_states.dtype == torch.int32
        assert torch.isfinite(r.final_log_weights).all()
        assert r.resampled.shape == (1 + -(-15 // chunk),)
    if chunk == 4:
        assert any(bool(r.resampled.any()) for r in results)
    mean_ref, se_ref = _ref_logz_stats()
    assert abs(mean - mean_ref) < 4 * math.hypot(se, se_ref) + FLOOR, (
        mean, mean_ref)


@pytest.mark.parametrize("history", [True, False])
def test_unfused_paths_match_exact(history):
    obs = torch.as_tensor(OBS)
    if history:
        results = [smc(port_hmm.hmm_ssm, obs, N, i) for i in range(SEEDS)]
        r = results[0]
        assert r.states.shape == (16, N) and r.ancestors.shape == (16, N)
        post = r.filtered_mean(lambda s: s)
        assert post.shape == (16,) and torch.isfinite(post).all()
    else:     # exchange resampling, no history
        run = build_smc_run(port_hmm.hmm_ssm, N)
        results = [run(i, obs) for i in range(SEEDS)]
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    assert abs(mean - EXACT) < 4 * se + FLOOR, (mean, se)


def test_exact_posterior_and_oracle_match_reference():
    np.testing.assert_allclose(port_hmm.hmm_exact_posterior(OBS),
                               ref_hmm.hmm_exact_posterior(OBS), atol=1e-12)
    assert abs(port_hmm.hmm_log_evidence(OBS) - discrete_hmm_log_evidence(
        ref_hmm.HMM_TRANS, ref_hmm.HMM_MEANS, np.ones(3), np.full(3, 1 / 3),
        OBS)) < 1e-10
    assert abs(port_hmm.hmm_log_evidence(OBS) - EXACT) < 1e-5
    # a 4-state chain with its own stds and initial probabilities
    rng = np.random.RandomState(9)
    trans = rng.dirichlet(np.ones(4), size=4)
    means, stds = rng.normal(size=4), rng.uniform(0.5, 2.0, 4)
    init = rng.dirichlet(np.ones(4))
    ys = rng.normal(size=12)
    assert abs(port_hmm.hmm_log_evidence(ys, trans, means, stds, init)
               - discrete_hmm_log_evidence(trans, means, stds, init, ys)) < 1e-10


@pytest.mark.parametrize("flag", [0, 1])
def test_step_exchange_matches_pallas_interpret(flag):
    """K4: one step with the flagged exchange resample, as a one-step
    launch of the chunk kernel's plain version, against
    ``pallas_hmm_fused_step_exchange(interpret=True)`` (u = 0)."""
    from cpprob_tpu.ops.pallas_hmm import pallas_hmm_fused_step_exchange
    from cpprob_tpu_torch.interop import population_from_numpy, spec_from_numpy

    n = 2 * ISLAND_SIZE
    states, log_w = _population(20 + flag, n, 2.0)
    ticks = np.array([n // 3, 3 * n // 4], np.int32)
    y = np.float32(0.4)
    s_j, w_j, ess, cat_w, lme = pallas_hmm_fused_step_exchange(
        jnp.int32(0), jnp.asarray(states), jnp.asarray(log_w), jnp.float32(y),
        jnp.int32(flag), jnp.asarray(ticks), block_r=32, interpret=True)
    spec = spec_from_numpy(ref_hmm.HMM_TRANS, ref_hmm.HMM_MEANS, np.ones(3),
                           np.full(3, 1 / 3))
    s_t, w_t = population_from_numpy(states, log_w, device="cpu")
    ctrl = torch.tensor([flag, *ticks, 1], dtype=torch.int32)
    s, w, rec = hmm_chunk_plain(0, s_t, w_t, torch.tensor([y]), ctrl, spec,
                                t0=5, draws=(torch.zeros(1, n), None))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5)
    ess_p, cat_p, lme_p = stats_from_partials(rec, n)
    np.testing.assert_allclose(float(ess_p), float(ess), rtol=1e-5)
    np.testing.assert_allclose(cat_p.numpy(), np.asarray(cat_w), atol=1e-6)
    np.testing.assert_allclose(float(lme_p), float(lme), rtol=1e-5)


def test_step_hooks_are_one_step_chunk_launches():
    """The three per-step hooks of ``make_fused_hmm_ssm`` are the chunk
    kernel at n_steps = 1 and t0 = t: the same draws as a chunk step at
    that absolute time."""
    model = make_fused_hmm_ssm()
    n = ISLAND_SIZE
    states, log_w = (torch.as_tensor(a) for a in _population(6, n, 1.0))
    y = torch.tensor(0.25)
    ctrl = torch.tensor([0, 0, 0, 3], dtype=torch.int32)
    ys = torch.tensor([0.25, -1.0, 2.0])
    spec = port_smc_spec()
    s3, w3, _ = hmm_chunk_plain(4, states, log_w, ys, ctrl, spec, t0=7)
    s1, w1 = model.fused_step_batch(4, states, log_w, y, 7)
    s2, w2, ess = model.fused_step_ess_batch(4, states, log_w, y, 7)
    ticks = torch.tensor([n // 2, n], dtype=torch.int32)
    s4, w4, ess4, cat4, lme4 = model.fused_step_exchange_batch(
        4, states, log_w, y, 7, torch.tensor(0, dtype=torch.int32), ticks)
    one, _, _ = hmm_chunk_plain(4, states, log_w, ys[:1], torch.tensor(
        [0, 0, 0, 1], dtype=torch.int32), spec, t0=7)
    for s_ in (s1, s2, s4):
        assert torch.equal(s_, one)
    assert torch.equal(w1, w2) and torch.equal(w2, w4)
    np.testing.assert_allclose(float(ess), float(rs.ess(w1)), rtol=1e-5)
    # the next step of the three-step chunk is the hook at t = 8
    s8, _ = model.fused_step_batch(4, one, w1, ys[1], 8)
    s3b, _, _ = hmm_chunk_plain(4, states, log_w, ys[:2], torch.tensor(
        [0, 0, 0, 2], dtype=torch.int32), spec, t0=7)
    assert torch.equal(s8, s3b)
    # flag on: the population is rebuilt from the ticks before the step
    s5, w5, *_ = model.fused_step_exchange_batch(
        4, states, log_w, y, 7, torch.tensor(1, dtype=torch.int32), ticks)
    assert float(w5.std()) < float(w1.std())


def port_smc_spec():
    from cpprob_tpu_torch.interop import spec_from_numpy

    return spec_from_numpy(port_hmm.HMM_TRANS, port_hmm.HMM_MEANS, np.ones(3),
                           np.full(3, 1 / 3))


@pytest.mark.parametrize("route", ["exchange_chunk1", "smc_history"])
def test_per_step_fused_routes_match_exact(route):
    """chunk = 1 takes the per-step exchange route (K4, started from
    ``init_sample_batch``); smc() keeps the history and takes
    ``fused_step_ess_batch`` (K5)."""
    obs = torch.as_tensor(OBS)
    model = make_fused_hmm_ssm()
    if route == "exchange_chunk1":
        run = build_smc_run(model, N)
        results = [run(i, obs) for i in range(SEEDS)]
        assert all(r.resampled.shape == (16,) for r in results)
    else:
        results = [smc(model, obs, N, i) for i in range(SEEDS)]
        r = results[0]
        assert r.states.shape == (16, N) and r.ancestors.shape == (16, N)
        assert r.states.dtype == torch.int32
    assert any(bool(r.resampled.any()) for r in results)
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    assert abs(mean - EXACT) < 4 * se + FLOOR, (mean, se)


def test_per_step_exchange_glue_matches_reference():
    """The per-step exchange glue's decision, ticks and evidence increment
    against the reference's ``make_smc_step_exchange_fused``."""
    n = 1 << 12
    states, log_w = _population(8, n, 3.0)
    ess = float(ref_rs.ess(log_w))
    cat_w = np.array(ref_rs.category_weights(log_w, states, 3))
    lme = float(jax.scipy.special.logsumexp(log_w) - np.log(n))
    seen = {}

    def capture_ref(key, s, w, y, t, flag, ticks):
        seen["ref"] = (int(flag), np.asarray(ticks), int(t))
        return s, w, jnp.float32(n), jnp.ones(3) / 3, jnp.float32(0.0)

    def capture_port(key, s, w, y, t, flag, ticks):
        seen["port"] = (int(flag), ticks.numpy(), int(t))
        return s, w, torch.tensor(float(n)), torch.ones(3) / 3, torch.tensor(0.0)

    key = jax.random.key(6)
    ref_model = dataclasses.replace(ref_hmm.hmm_ssm,
                                    fused_step_exchange_batch=capture_ref)
    ref_step = ref_smc.make_smc_step_exchange_fused(ref_model, n, 0.5)
    carry = (key, jnp.asarray(states), jnp.asarray(log_w), jnp.float32(-2.0),
             jnp.float32(ess), jnp.asarray(cat_w), jnp.float32(lme))
    (_, _, _, log_z_ref, *_), (do_ref,) = ref_step(carry, (jnp.float32(0.3), 4))
    u0 = float(jax.random.uniform(jax.random.split(key, 3)[1], ()))
    port_model = dataclasses.replace(port_hmm.hmm_ssm,
                                     fused_step_exchange_batch=capture_port)
    step = port_smc.make_smc_step_exchange_fused(port_model, n, 0.5)
    carry = carry_from_numpy(6, states, log_w, -2.0, ess, cat_w, lme, device="cpu")
    (_, _, _, log_z_port, *_), (do_port,) = step(
        carry, (torch.tensor(0.3), 4), u0=u0)
    assert bool(do_port) == bool(do_ref) is True
    assert seen["port"][0] == seen["ref"][0] == 1 and seen["port"][2] == 4
    assert np.abs(seen["port"][1].astype(np.int64) - seen["ref"][1]).max() <= 1
    np.testing.assert_allclose(float(log_z_port), float(log_z_ref), atol=1e-6)


@pytest.mark.cuda
def test_step_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    errs = chip_smoke.check_step_kernels(1 << 16)
    assert errs["step_exchange"] < 1e-4 and errs["step_ess"] < 1e-4


def test_unported_combinations_raise():
    # no chunk kernel on the model: an error in the reference too
    with pytest.raises(ValueError, match="fused_chunk"):
        build_smc_run(port_hmm.hmm_ssm, N, chunk=16)
    # per-particle hooks (slice 4b) run under vmap: nothing left to raise
    obs = torch.as_tensor(OBS[:4])
    run = build_smc_run(dataclasses.replace(port_hmm.hmm_ssm, state_categories=None,
                                            step_sample_batch=None), 256)
    assert run(0, obs).final_states.shape == (256,)
    guided = dataclasses.replace(
        port_hmm.hmm_ssm, obs_logpdf_batch=None,
        proposal_sample=lambda g, s, t, y: port_hmm.hmm_ssm.step_sample_batch(g, s, t),
        proposal_logpdf=lambda ns, s, t, y: port_hmm.hmm_ssm.step_logpdf(ns, s, t))
    assert math.isfinite(float(build_smc_run(guided, 256)(0, obs).log_evidence))


def _per_particle_only(model):
    return dataclasses.replace(model, init_sample_batch=None, step_sample_batch=None,
                               obs_logpdf_batch=None)


@pytest.mark.parametrize("model", ["lg", "hmm"])
def test_per_particle_hooks_match_exact(model):
    """A model with only per-particle hooks (``init_sample``,
    ``step_sample``, ``obs_logpdf``) runs them under vmap, with and
    without history, against Kalman or the forward recursion."""
    from cpprob_tpu_torch.models import linear_gaussian as port_lg

    if model == "lg":
        ys = port_lg.simulate_observations(16, 0)
        ssm, exact = port_lg.linear_gaussian_ssm, port_lg.kalman_filter_1d(ys)[2]
    else:
        ys, ssm, exact = OBS, port_hmm.hmm_ssm, EXACT
    pp = _per_particle_only(ssm)
    obs = torch.as_tensor(ys)
    unfused = build_smc_run(pp, N)
    for run in (lambda seed: smc(pp, obs, N, seed), lambda seed: unfused(seed, obs)):
        mean, se = _mean_se([float(run(100 + s).log_evidence) for s in range(SEEDS)])
        assert abs(mean - exact) < 4 * se + FLOOR, (model, mean, se, exact)
    res = smc(pp, obs, 1 << 10, 0)
    assert res.states.shape == (len(ys), 1 << 10)


def test_filtered_mean_matches_reference():
    """``fn`` maps one particle's state, as in the reference: on (T, N, 2)
    states ``s[0]`` and ``s.sum()`` are per-particle functions."""
    rng = np.random.RandomState(6)
    T, n = 4, 8
    lw = rng.normal(size=(T, n)).astype(np.float32)
    fns = {"identity": (lambda s: s, lambda s: s),
           "square": (lambda s: s ** 2, lambda s: s ** 2),
           "first": (lambda s: s[0], lambda s: s[0]),
           "sum": (lambda s: s.sum(), lambda s: s.sum())}
    for shape in ((T, n), (T, n, 2)):
        states = rng.normal(size=shape).astype(np.float32)
        ones = np.ones((n,) + shape[2:], np.float32)

        def result(mod, arr):
            return mod.SMCResult(arr(states), arr(lw), None, arr(np.zeros(T, bool)),
                                 arr(np.float32(0.0)), arr(ones), arr(lw[-1]))

        port = result(port_smc, torch.as_tensor)
        ref = result(ref_smc, jnp.asarray)
        for name, (pf, jf) in fns.items():
            if len(shape) == 2 and name == "first":
                continue
            np.testing.assert_allclose(port.filtered_mean(pf).numpy(),
                                       np.asarray(ref.filtered_mean(jf)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} {shape}")


def test_chunk_hook_without_absolute_time_raises():
    """A model's own chunk hooks without absolute time
    (``fused_chunk_exchange_batch``, ``fused_chunk_batch``) are driven, no
    longer refused: each chunk's hook gets ``chunk_seed(seed, t0)``, the
    counterpart of the reference's per-chunk key.  The exchange path (the
    HMM chunk kernel's plain version behind a hook without time) equals
    the hand-driven chunks bit for bit and holds the exact evidence; the
    continuous path (a plain-PyTorch chunk on the LG model) holds Kalman
    and the reference's ``build_smc_run`` on its ``xla_chunk`` twin, within
    4 SE + 0.02.  The time-aware hook keeps precedence."""
    from _torch_parallel_worker import torch_chunk

    fused = make_fused_hmm_ssm()
    seeds_seen = []

    def own(seed, *a):
        seeds_seen.append(seed)
        return fused.fused_chunk_exchange_t_batch(seed, *a, 1)

    model = dataclasses.replace(fused, fused_chunk_exchange_t_batch=None,
                                fused_chunk_exchange_batch=own)
    obs = torch.as_tensor(OBS)
    run = build_smc_run(model, N, chunk=4)
    zs = [float(run(s, obs).log_evidence) for s in range(SEEDS)]
    assert seeds_seen[:4] == [port_smc.chunk_seed(0, 1 + 4 * c) for c in range(4)]
    assert len(set(seeds_seen)) == len(seeds_seen)
    mean, se = _mean_se(zs)
    assert abs(mean - EXACT) < 4 * se + FLOOR, (mean, se)
    # the same sweep with the hook wrapped by hand into a time-aware one
    by_hand = dataclasses.replace(
        fused, fused_chunk_exchange_t_batch=lambda seed, *a: fused.fused_chunk_exchange_t_batch(
            port_smc.chunk_seed(seed, a[-1]), *a[:-1], 1))
    a, b = run(3, obs), build_smc_run(by_hand, N, chunk=4)(3, obs)
    assert torch.equal(a.final_states, b.final_states)
    assert float(a.log_evidence) == float(b.log_evidence)
    step = make_smc_step_exchange_fused_chunked(model, N, 0.5)
    assert callable(step)
    # precedence: with both hooks the time-aware one runs
    both = dataclasses.replace(fused, fused_chunk_exchange_batch=lambda *a: 1 / 0)
    build_smc_run(both, N, chunk=4)(0, obs)

    from cpprob_tpu_torch.models import kalman_filter_1d, linear_gaussian_ssm

    ys = np.random.RandomState(12).normal(0.0, 1.2, size=25).astype(np.float32)
    lg = dataclasses.replace(linear_gaussian_ssm, fused_chunk_batch=torch_chunk)
    run = build_smc_run(lg, N, chunk=4)
    zs = [float(run(s, torch.as_tensor(ys)).log_evidence) for s in range(SEEDS)]
    mean, se = _mean_se(zs)
    kalman = float(kalman_filter_1d(ys)[2])
    assert abs(mean - kalman) < 4 * se + FLOOR, (mean, se, kalman)
    half_log_2pi = 0.9189385332046727

    def xla_chunk(key_, states, log_w, ys_, n_valid):
        def body(carry, inp):
            x, w = carry
            y, i = inp
            nx = x + jax.random.normal(jax.random.fold_in(key_, i), x.shape)
            d = y - nx
            valid = i < n_valid
            return (jnp.where(valid, nx, x),
                    jnp.where(valid, w + (-0.5 * d * d - half_log_2pi), w)), None

        (x, w), _ = jax.lax.scan(body, (states, log_w),
                                 (ys_, jnp.arange(ys_.shape[0], dtype=jnp.int32)))
        p = jax.nn.softmax(w)
        return x, w, 1.0 / jnp.sum(p * p)

    ref_lg = importlib.import_module("cpprob_tpu.models.linear_gaussian").linear_gaussian_ssm
    ref_run = jax.jit(ref_smc.build_smc_run(
        dataclasses.replace(ref_lg, fused_chunk_batch=xla_chunk), N, chunk=4))
    ref = [float(ref_run(jax.random.key(s), jnp.asarray(ys)).log_evidence)
           for s in range(SEEDS)]
    rmean, rse = _mean_se(ref)
    assert abs(mean - rmean) < 4 * (se + rse) + FLOOR, (mean, se, rmean, rse)


def test_stage_timer_and_env_versions():
    from cpprob_tpu_torch.util.profiling import StageTimer, env_versions

    st = StageTimer()
    for _ in range(2):
        with st.stage("a", sync=True):
            pass
    d = st.as_dict()
    assert d["a"]["calls"] == 2 and d["a"]["total_s"] >= 0.0
    assert "a" in st.report()
    v = env_versions()
    assert v["torch"] == torch.__version__
    assert {"cuda", "numpy", "python", "device",
            "nvidia_smi_name_power_limit"} <= set(v)


def test_port_imports_without_jax():
    """Every module of the port, and ``chip_smoke``, imports with JAX made
    unimportable, and loads no ``jax*`` module, no ``cpprob_tpu`` module
    and no ``triton``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import cpprob_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cpprob_tpu_torch.__path__, 'cpprob_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert 'cpprob_tpu_torch.util.roofline' in names, names\n"
        "assert 'cpprob_tpu_torch.ops.calibrate' in names, names\n"
        "for m in ('core.handlers', 'core.primitives', 'core.scanner', 'inference.sis',\n"
        "          'postprocess.empirical', 'postprocess.stats', 'postprocess.diagnostics',\n"
        "          'util.numerics', 'models.gaussian', 'models.all_distr',\n"
        "          'models.rejection', 'models.poly', 'inference.nn', 'inference.csis',\n"
        "          'inference.csis_dynamic', 'inference.regularize', 'io.serialization',\n"
        "          'io.tracefile', 'util.checkpoint', 'util.logging', 'util.ndarray',\n"
        "          'util.pytree', 'entry', 'inference.potential', 'inference.hmc',\n"
        "          'inference.chees', 'inference.nuts', 'inference.svi',\n"
        "          'inference.predictive', 'inference.smc_sampler',\n"
        "          'inference.particle_gibbs', 'inference.smc2', 'parallel',\n"
        "          'parallel.mesh', 'parallel.distributed', 'parallel._collectives',\n"
        "          'parallel.resampling', 'parallel.sis', 'parallel.smc',\n"
        "          'util.sharded_parts', 'cli', 'external', 'models.sherpa',\n"
        "          'examples', 'examples.sherpa_gen', 'examples.calo_variance',\n"
        "          'examples.sherpa_fullscale', 'examples.external_simulator',\n"
        "          'examples.quickstart', 'examples.thesis_hmm_comparison',\n"
        "          'examples.posterior_parse_bench', 'examples.csis_bench',\n"
        "          'examples.kernel_bench', 'util.device', 'util.seeds'):\n"
        "    assert 'cpprob_tpu_torch.' + m in names, (m, names)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and (\n"
        "    m.startswith('jax') or m == 'cpprob_tpu'\n"
        "    or m.startswith('cpprob_tpu.') or m.split('.')[0] == 'triton')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
