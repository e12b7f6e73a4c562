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
from cpprob_tpu_torch.models import hmm as port_hmm
from cpprob_tpu_torch.ops.fused_hmm import ISLAND_SIZE, make_fused_hmm_ssm

# the packages' ``hmm`` and ``smc`` attributes are functions, not the modules
ref_hmm = importlib.import_module("cpprob_tpu.models.hmm")
ref_smc = importlib.import_module("cpprob_tpu.inference.smc")

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
    carry = carry_from_numpy(4, states, log_w, log_z, ess, cat_w, lme)
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


def test_unported_combinations_raise():
    # no chunk kernel on the model: an error in the reference too
    with pytest.raises(ValueError, match="fused_chunk"):
        build_smc_run(port_hmm.hmm_ssm, N, chunk=16)
    with pytest.raises(NotImplementedError, match="K11"):
        build_smc_run(dataclasses.replace(port_hmm.hmm_ssm, state_categories=None,
                                          vector_state_dim=2), N)
    with pytest.raises(NotImplementedError, match="slice 3"):
        build_smc_run(dataclasses.replace(port_hmm.hmm_ssm,
                                          proposal_sample=lambda *a: None), N)


def test_chunk_hook_without_absolute_time_raises():
    model = dataclasses.replace(port_hmm.hmm_ssm,
                                fused_chunk_exchange_batch=lambda *a: None)
    with pytest.raises(NotImplementedError, match="slice 2"):
        build_smc_run(model, N, chunk=16)
    with pytest.raises(NotImplementedError, match="fused_chunk_exchange_batch"):
        make_smc_step_exchange_fused_chunked(model, N, 0.5)


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
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import cpprob_tpu_torch, cpprob_tpu_torch.interop\n"
        "import cpprob_tpu_torch.ops.fused_hmm, cpprob_tpu_torch.util.profiling\n"
        "import cpprob_tpu_torch.ops.fused_lg, cpprob_tpu_torch.ops.stream_resample\n"
        "import cpprob_tpu_torch.models.linear_gaussian\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('cpprob_tpu.') for m in sys.modules if sys.modules[m])\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
