"""The port's continuous-state SMC slice (``cpprob_tpu_torch``: the
linear-Gaussian model, its fused kernel and the chunked glue) against the
JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions.  The
Pallas kernel runs in interpret mode, which pins its Box-Muller draws to
u1 = 0.5, u2 = 0: the plain version gets the same ε (√(2 ln 2) at even
chunk-local steps, 0 at odd ones).  Statistical checks use the 4·SE + 0.02
rule against the Kalman filter and the JAX package's own estimate.
"""

import dataclasses
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.ops.pallas_hmm import pallas_lg_fused_chunk
from cpprob_tpu_torch import build_smc_run, smc
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.interop import population_from_numpy
from cpprob_tpu_torch.models import hmm_ssm
from cpprob_tpu_torch.models.linear_gaussian import (
    kalman_filter_1d,
    linear_gaussian_ssm,
    simulate_observations,
)
from cpprob_tpu_torch.ops import fused_lg
from cpprob_tpu_torch.ops import stream_resample as sr
from cpprob_tpu_torch.ops.fused_hmm import stats_from_partials
from cpprob_tpu_torch.ops.fused_lg import (
    LG_BLOCK,
    lg_chunk,
    lg_chunk_plain,
    lg_init,
    lg_init_plain,
    lg_step,
    lg_step_ctrl,
    lg_step_ctrl_plain,
    lg_step_plain,
    make_fused_lg_ssm,
)

ref_lg = importlib.import_module("cpprob_tpu.models.linear_gaussian")
ref_smc = importlib.import_module("cpprob_tpu.inference.smc")
# the package's ``smc`` attribute is the function, not the module
port_smc = importlib.import_module("cpprob_tpu_torch.inference.smc")

torch.set_num_threads(2)

N = 1 << 14
SEEDS = 8
FLOOR = 0.02
OBS = simulate_observations(16, 0)


def _mean_se(vals):
    vals = np.asarray(vals, np.float64)
    return vals.mean(), vals.std(ddof=1) / math.sqrt(len(vals))


def _population(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(0.0, 1.5, size=8).astype(np.float32))


@pytest.mark.parametrize("k,n_steps,n_valid", [
    (1, 8, 8), (3, 8, 7), (3, 5, 5), (1, 5, 2)])
def test_chunk_matches_pallas_interpret(k, n_steps, n_valid):
    n = 1024 * k
    x, w, ys = _population(10 * k + n_steps, n)
    ys = ys[:n_steps]
    s_j, w_j, ess_j = pallas_lg_fused_chunk(
        jnp.int32(0), jnp.asarray(x), jnp.asarray(w), jnp.asarray(ys),
        jnp.int32(n_valid), n_steps=n_steps, block_r=8, interpret=True)
    r = np.sqrt(np.float32(-2.0) * np.log(np.float32(0.5)))
    eps = torch.tensor([r if t % 2 == 0 else 0.0 for t in range(n_steps)],
                       dtype=torch.float32)[:, None]
    x_t, w_t = population_from_numpy(x, w, device="cpu")
    assert x_t.dtype == torch.float32
    s, lw, rec = lg_chunk_plain(0, x_t, w_t, torch.as_tensor(ys),
                                torch.tensor(n_valid, dtype=torch.int32),
                                draws=eps)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(lw.numpy(), np.asarray(w_j), atol=1e-5)
    assert rec.shape == (-(-n // LG_BLOCK), 3)
    np.testing.assert_allclose(float(stats_from_partials(rec, n)[0]),
                               float(ess_j), rtol=1e-5)


@pytest.mark.parametrize("t0", [1, 2])
def test_draws_do_not_depend_on_chunking(t0):
    """Eight one-step launches give one eight-step launch, bit for bit, and
    a chunk split 3 + 5 gives the same too (pairing by absolute step)."""
    x, w, ys = _population(7, 8192)
    x, w, ys = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(ys)
    one_s, one_w, _ = lg_chunk_plain(5, x, w, ys, t0=t0)
    s, lw = x, w
    for t in range(8):
        s, lw = lg_step_plain(5, s, lw, ys[t], t0 + t)
    assert torch.equal(s, one_s) and torch.equal(lw, one_w)
    s, lw, _ = lg_chunk_plain(5, x, w, ys[:3], t0=t0)
    s, lw, _ = lg_chunk_plain(5, s, lw, ys[3:], t0=t0 + 3)
    assert torch.equal(s, one_s) and torch.equal(lw, one_w)
    # a masked tail leaves the particles where n_valid stopped them
    s3, lw3, _ = lg_chunk_plain(5, x, w, ys, torch.tensor(3, dtype=torch.int32),
                                t0=t0)
    s, lw, _ = lg_chunk_plain(5, x, w, ys[:3], t0=t0)
    assert torch.equal(s3, s) and torch.equal(lw3, lw)


def test_moves_and_weights_follow_the_model():
    n = 1 << 16
    x0 = torch.zeros(n)
    s, lw, rec = lg_chunk_plain(11, x0, torch.zeros(n), torch.tensor([0.4, -0.3]),
                                t0=4)
    eps1 = s.numpy().astype(np.float64)
    assert abs(eps1.mean()) < 4 * np.sqrt(2 / n)
    assert abs(eps1.var() - 2.0) < 0.05                  # two N(0, 1) steps
    s1, lw1, _ = lg_chunk_plain(11, x0, torch.zeros(n), torch.tensor([0.4]), t0=4)
    e1 = s1.numpy().astype(np.float64)
    e2 = eps1 - e1
    assert abs(np.corrcoef(e1, e2)[0, 1]) < 4 / np.sqrt(n)  # cos and sin halves
    np.testing.assert_allclose(np.quantile(e1, [0.1, 0.5, 0.9]),
                               [-1.2816, 0.0, 1.2816], atol=0.03)
    want = (-0.5 * (0.4 - e1) ** 2 - 0.5 * (-0.3 - eps1) ** 2
            - np.log(2 * np.pi))
    np.testing.assert_allclose(lw.numpy(), want, atol=1e-4)
    m = float(lw.max())
    e = np.exp(lw.numpy().astype(np.float64) - m)
    ess, cat_w, lme = stats_from_partials(rec, n)
    assert cat_w.shape == (0,)
    np.testing.assert_allclose(float(ess), e.sum() ** 2 / (e * e).sum(), rtol=1e-5)
    np.testing.assert_allclose(float(lme), m + np.log(e.mean()), rtol=1e-6)


def _old_combiner(records, n):
    """``stats_from_partials`` as the HMM slice first wrote it."""
    r = records.double()
    m_b, s1_b, s2_b, c_bk = r[:, 0], r[:, 1], r[:, 2], r[:, 3:-1]
    m = m_b.max()
    scale = torch.exp(m_b - m)
    s1 = torch.sum(s1_b * scale)
    s2 = torch.sum(s2_b * scale * scale)
    ess = s1 * s1 / torch.clamp(s2, min=1e-300)
    cat_w = torch.sum(c_bk * scale[:, None], 0) / torch.clamp(s1, min=1e-300)
    lme = m + torch.log(torch.clamp(s1, min=1e-300)) - math.log(n)
    return ess, cat_w, lme


@pytest.mark.parametrize("K", [3, 5])
def test_one_combiner_for_both_record_layouts(K):
    rng = np.random.RandomState(K)
    rec = np.abs(rng.normal(size=(16, K + 4))).astype(np.float32)
    rec[:, 0] = rng.normal(size=16)
    rec = torch.as_tensor(rec)
    for new, old in zip(stats_from_partials(rec, 1 << 16),
                        _old_combiner(rec, 1 << 16)):
        assert torch.equal(new, old)
    ess, cat_w, lme = stats_from_partials(rec[:, :3].contiguous(), 1 << 16)
    ess_k, _, lme_k = stats_from_partials(rec, 1 << 16)
    assert cat_w.shape == (0,)
    assert torch.equal(ess, ess_k) and torch.equal(lme, lme_k)


def test_wrappers_dispatch_cpu_to_plain():
    x, w, ys = (torch.as_tensor(a) for a in _population(3, 4096))
    before = dict(fused_lg.LAUNCHES)
    for a, b in zip(lg_chunk(2, x, w, ys, t0=3), lg_chunk_plain(2, x, w, ys, t0=3)):
        assert torch.equal(a, b)
    for a, b in zip(lg_step(2, x, w, ys[0], 6), lg_step_plain(2, x, w, ys[0], 6)):
        assert torch.equal(a, b)
    assert fused_lg.LAUNCHES == before


def test_step_ctrl_plain_resets_and_decides():
    """The one-step launch with the step's resample control, plain: a set
    flag starts every particle from weight 0 (the old weights unread), an
    unset one moves the weights on; the ESS is ``stats_from_partials`` on
    the records and the next flag ``ess < threshold``.  The wrapper takes
    the plain version on CPU tensors and counts no launch."""
    x, w, ys = (torch.as_tensor(a) for a in _population(6, 3 * LG_BLOCK + 5))
    n = x.shape[0]
    on, off = torch.tensor(1, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)
    before = dict(fused_lg.LAUNCHES)
    for flag, w_in in ((off, w), (on, torch.zeros(n))):
        xs, ws, ess, nxt = lg_step_ctrl(4, x, w, ys[0], 3, flag, 0.5 * n)
        xr, wr, rec = lg_chunk_plain(4, x, w_in, ys[:1], t0=3)
        assert torch.equal(xs, xr) and torch.equal(ws, wr)
        assert torch.equal(ess, stats_from_partials(rec, n)[0])
        assert ess.dtype == torch.float64 and nxt.dtype == torch.int32
        assert int(nxt) == int(float(ess) < 0.5 * n)
        for a, b in zip((xs, ws, ess, nxt),
                        lg_step_ctrl_plain(4, x, w, ys[0], 3, flag, 0.5 * n)):
            assert torch.equal(a, b)
        for thresh in (0.99 * float(ess), 1.01 * float(ess)):
            assert int(lg_step_ctrl(4, x, w, ys[0], 3, flag, thresh)[3]) == (
                float(ess) < thresh)
    far = lg_step_ctrl(4, x, w + 7.0, ys[0], 3, on, 0.5 * n)
    assert torch.equal(far[1], lg_step_ctrl(4, x, w, ys[0], 3, on, 0.5 * n)[1])
    assert fused_lg.LAUNCHES == before


@pytest.mark.parametrize("n", [1000, 3 * LG_BLOCK + 5])
def test_init_plain_is_the_step_0_chunk(n):
    """The sweep's start, plain: the one-step chunk at absolute time 0 on
    zero states and weights, bit for bit; the ESS is ``stats_from_partials``
    on those records and the first flag ``ess < threshold``, on either
    side of the ESS.  The wrapper takes the plain version on a CPU tensor
    and counts no launch."""
    y0 = torch.tensor(0.7)
    zeros = torch.zeros(n)
    before = dict(fused_lg.LAUNCHES)
    x, w, ess, flag = lg_init(9, n, y0, 0.5 * n)
    xr, wr, rec = lg_chunk_plain(9, zeros, zeros, y0[None], t0=0)
    assert torch.equal(x, xr) and torch.equal(w, wr)
    assert torch.equal(ess, stats_from_partials(rec, n)[0])
    assert ess.dtype == torch.float64 and flag.dtype == torch.int32
    assert int(flag) == int(float(ess) < 0.5 * n)
    for a, b in zip((x, w, ess, flag), lg_init_plain(9, n, y0, 0.5 * n)):
        assert torch.equal(a, b)
    for thresh in (0.99 * float(ess), 1.01 * float(ess)):
        assert int(lg_init(9, n, y0, thresh)[3]) == (float(ess) < thresh)
    assert fused_lg.LAUNCHES == before


def test_init_draws_are_standard_normal():
    """x_0 of 2^16 particles: mean and variance within 4 standard errors of
    N(0, 1), the weights log N(y_0; x_0, 1), and the draw independent of
    step 1's (the sin half of the same Philox pair)."""
    n = 1 << 16
    x, w, _, _ = lg_init_plain(21, n, torch.tensor(-0.4), 0.5 * n)
    xs = x.numpy().astype(np.float64)
    assert abs(xs.mean()) < 4 / math.sqrt(n)
    assert abs(xs.var() - 1.0) < 4 * math.sqrt(2 / n)
    np.testing.assert_allclose(w.numpy(), -0.5 * (-0.4 - xs) ** 2
                               - 0.5 * np.log(2 * np.pi), atol=1e-5)
    x1, _, _ = lg_chunk_plain(21, x, w, torch.tensor([0.0]), t0=1)
    eps1 = x1.numpy().astype(np.float64) - xs
    assert abs(np.corrcoef(xs, eps1)[0, 1]) < 4 / math.sqrt(n)


@pytest.mark.parametrize("spread", [0.5, 8.0])
def test_final_log_mean_exp_takes_k14_on_the_streaming_path(spread):
    """The sweep's close: on the streaming path the log-mean-exp of
    ``logsumexp_stats`` (float64), bit for bit, within 1e-5 (1 + |lme|) of
    the float32 ``_log_mean_exp``; off it, or for (n, D) states,
    ``_log_mean_exp`` itself."""
    n = 3 * LG_BLOCK + 7
    lw = torch.as_tensor((spread * np.random.RandomState(2).normal(size=n))
                         .astype(np.float32))
    states = torch.zeros(n)
    stats = sr.logsumexp_stats_plain(lw)
    want = stats[0] + torch.log(stats[1]) - math.log(n)
    got = port_smc.final_log_mean_exp(lw, states, True)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    lme32 = port_smc._log_mean_exp(lw)
    assert abs(float(got) - float(lme32)) < 1e-5 * (1 + abs(float(got)))
    for st, streaming in ((states, False), (torch.zeros(n, 2), True),
                          (states.double(), True)):
        assert torch.equal(port_smc.final_log_mean_exp(lw, st, streaming), lme32)


def _lg_params():
    """An untrained [3, 8, 2] proposal net for the guided LG model."""
    g = torch.Generator().manual_seed(0)
    return [{"w": 0.1 * torch.randn(3, 8, generator=g), "b": torch.zeros(8)},
            {"w": 0.1 * torch.randn(8, 2, generator=g), "b": torch.zeros(2)}]


@pytest.mark.parametrize("which", ["chunk8", "chunk1", "unfused", "attach_scalar",
                                   "history", "guided"])
def test_init_dispatch(which):
    """``build_smc_run(make_fused_lg_ssm(), n)`` at chunk 8 and 1 takes
    the path that starts with the model's ``fused_init_ctrl_batch``, once a
    sweep, and never draws from ``init_sample_batch``; the unfused model, a
    user-physics model (K10), ``smc()`` with history and the guided model
    keep the start from ``init_sample_batch`` (the attach builders clear
    the hook)."""
    from cpprob_tpu_torch.examples.kernel_bench import lg_step_elem
    from cpprob_tpu_torch.models.linear_gaussian import (
        obs_logpdf_elem,
        trans_logpdf_elem,
    )
    from cpprob_tpu_torch.ops.fused_ssm import (
        attach_fused_guided_scalar_kernels,
        attach_fused_scalar_kernels,
    )

    calls = []

    def spy(name, hook):
        return None if hook is None else (
            lambda *a, **k: calls.append(name) or hook(*a, **k))

    fused = make_fused_lg_ssm()
    model = {"chunk8": fused, "chunk1": fused, "history": fused,
             "unfused": linear_gaussian_ssm,
             "attach_scalar": attach_fused_scalar_kernels(fused, lg_step_elem),
             "guided": attach_fused_guided_scalar_kernels(
                 fused, _lg_params(), 16, trans_logpdf_elem=trans_logpdf_elem,
                 obs_logpdf_elem=obs_logpdf_elem)}[which]
    model = dataclasses.replace(
        model, init_sample_batch=spy("sample", model.init_sample_batch),
        fused_init_ctrl_batch=spy("init", model.fused_init_ctrl_batch))
    obs = torch.as_tensor(OBS)
    chunk = 8 if which in ("chunk8", "attach_scalar", "guided") else 1
    path = port_smc._sweep_path(model, 1024, 0.5, "systematic", which == "history",
                                chunk)
    assert path.name == {"chunk8": "chunk_value", "chunk1": "step_ctrl",
                         "attach_scalar": "chunk_value",
                         "guided": "chunk_value"}.get(which, "step")
    if which == "history":
        res = smc(model, obs, 1024, 3)
    else:
        res = build_smc_run(model, 1024, chunk=chunk)(3, obs)
    assert calls == (["init"] if which in ("chunk8", "chunk1") else ["sample"])
    assert np.isfinite(float(res.log_evidence))


def _chunked_one_step_a_chunk(seed, obs, n):
    """``make_smc_step_chunked`` on the fused LG model driven one step a
    chunk, started and closed as ``build_smc_run``'s sweep: the model's
    ``fused_init_ctrl_batch``, and ``final_log_mean_exp`` on the streaming
    path: (states, log_w, resampled flags, log Z)."""
    model = make_fused_lg_ssm()
    gen = torch.Generator().manual_seed(seed)
    states, log_w, ess, _ = model.fused_init_ctrl_batch(seed, n, obs[0], 0.5 * n)
    carry = ((seed, gen), states, log_w, torch.zeros((), dtype=torch.float64), ess)
    step = port_smc.make_smc_step_chunked(model, n, 0.5)
    flags = [torch.zeros(1, dtype=torch.bool)]
    one = torch.tensor(1, dtype=torch.int32)
    for t in range(1, obs.shape[0]):
        carry, (flag,) = step(carry, (obs[t:t + 1], one, t))
        flags.append(flag.reshape(1))
    states, log_w, log_z = carry[1:4]
    return states, log_w, torch.cat(flags), log_z + port_smc.final_log_mean_exp(
        log_w, states, True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_ctrl_body_matches_chunked_one_step_a_chunk(seed):
    """``build_smc_run(make_fused_lg_ssm(), n, chunk=1)`` takes the path
    whose one-step launch carries the resample flag, and gives the
    chunked body's run one step a chunk bit for bit: states, weights, the
    resample flags and log Z (both decide from ``stats_from_partials`` on
    the same records)."""
    n = 1 << 12
    obs = torch.as_tensor(OBS)
    path = port_smc._sweep_path(make_fused_lg_ssm(), n, 0.5, "systematic", False, 1)
    assert path.name == "step_ctrl"
    res = build_smc_run(make_fused_lg_ssm(), n, chunk=1)(seed, obs)
    states, log_w, flags, log_z = _chunked_one_step_a_chunk(seed, obs, n)
    assert res.resampled.dtype == torch.bool and res.resampled.shape == (16,)
    assert 2 <= int(flags.sum()) <= 14          # the series resamples, not always
    assert torch.equal(res.resampled, flags)
    assert torch.equal(res.final_states, states)
    assert torch.equal(res.final_log_weights, log_w)
    assert torch.equal(res.log_evidence, log_z)


@pytest.mark.parametrize("which", ["unfused", "attach_scalar", "history", "step_ctrl"])
def test_per_step_dispatch(which):
    """Only a scalar model with ``fused_step_ctrl_batch`` (no history,
    systematic resampling) takes the flag-carrying path at chunk 1: the
    unfused model, a user-physics model (K10) and ``smc()`` with history
    take the generic step (``make_smc_step``)."""
    from cpprob_tpu_torch.examples.kernel_bench import lg_step_elem
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_scalar_kernels

    obs = torch.as_tensor(OBS)
    model = {"unfused": linear_gaussian_ssm,
             "attach_scalar": attach_fused_scalar_kernels(
                 make_fused_lg_ssm(), lg_step_elem)}.get(which, make_fused_lg_ssm())
    path = port_smc._sweep_path(model, 1024, 0.5, "systematic", which == "history", 1)
    assert path.name == ("step_ctrl" if which == "step_ctrl" else "step")
    if which == "history":
        res = smc(model, obs, 1024, 3)
        assert res.states.shape == (16, 1024)
    else:
        res = build_smc_run(model, 1024, chunk=1)(3, obs)
    assert res.resampled.dtype == torch.bool and np.isfinite(float(res.log_evidence))


def test_kalman_matches_reference():
    for seed in range(3):
        obs = np.random.RandomState(seed).normal(0, 1.5, 20).astype(np.float32)
        ms, ps, ll = kalman_filter_1d(obs)
        ms_r, ps_r, ll_r = ref_lg.kalman_filter_1d(jnp.asarray(obs))
        np.testing.assert_allclose(ms, np.asarray(ms_r), atol=1e-6)
        np.testing.assert_allclose(ps, np.asarray(ps_r), atol=1e-6)
        assert abs(ll - float(ll_r)) < 1e-5 * max(1.0, abs(ll))
    assert simulate_observations(16, 0).dtype == np.float32


@functools.lru_cache(maxsize=1)
def _ref_logz_stats():
    run = jax.jit(ref_smc.build_smc_run(ref_lg.linear_gaussian_ssm, N))
    obs = jnp.asarray(OBS)
    return _mean_se([float(run(jax.random.key(200 + i), obs).log_evidence)
                     for i in range(SEEDS)])


@pytest.mark.parametrize("path", ["chunk8", "chunk1", "unfused"])
def test_slice_matches_kalman_and_reference(path):
    """chunk8 is the slice's main path (two chunk launches and the
    streaming epoch at the t = 9 boundary), chunk1 the per-step kernel path,
    unfused the model's own hooks; all resample through the streaming
    epoch's plain versions."""
    if path == "unfused":
        run = build_smc_run(linear_gaussian_ssm, N)
    else:
        run = build_smc_run(make_fused_lg_ssm(), N, chunk=int(path[5:]))
    obs = torch.as_tensor(OBS)
    results = [run(i, obs) for i in range(SEEDS)]
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    exact = kalman_filter_1d(OBS)[2]
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)
    mean_ref, se_ref = _ref_logz_stats()
    assert abs(mean - mean_ref) < 4 * math.hypot(se, se_ref) + FLOOR, (
        mean, mean_ref)
    for r in results:
        assert r.final_states.shape == (N,) and r.final_states.dtype == torch.float32
        assert torch.isfinite(r.final_log_weights).all()
        assert bool(r.resampled.any())
    if path == "chunk8":
        assert results[0].resampled.shape == (3,)
        assert all(bool(r.resampled[2]) for r in results)   # the t = 9 epoch


def test_filtered_means_match_kalman():
    obs = np.random.RandomState(2).normal(0, 1.0, size=15).astype(np.float32)
    res = smc(linear_gaussian_ssm, torch.as_tensor(obs), 16384, 0)
    ms, _, _ = kalman_filter_1d(obs)
    np.testing.assert_allclose(res.filtered_mean().numpy(), ms, atol=0.08)


def test_chunk_glue_resamples_on_the_flag_only():
    """The chunked glue with a spy chunk hook: a collapsed population
    resamples (weights reset, evidence increment added); a healthy one is
    passed on as it was, and the epoch runs with its flag off."""
    n = 1 << 12
    x, _, ys = _population(4, n)
    seen = []

    def spy_chunk(key, states, log_w, ys_, n_valid, t0):
        seen.append((states.clone(), log_w.clone(), t0))
        return states, log_w, torch.tensor(float(n))

    model = dataclasses.replace(linear_gaussian_ssm, fused_chunk_t_batch=spy_chunk)
    step = port_smc.make_smc_step_chunked(model, n, 0.5)
    for spread, fire in ((0.01, False), (4.0, True)):
        seen.clear()
        lw = (spread * np.random.RandomState(5).normal(size=n)).astype(np.float32)
        gen = torch.Generator().manual_seed(1)
        xs, lws = population_from_numpy(x, lw, device="cpu")
        carry = ((1, gen), xs, lws, torch.tensor(-1.0, dtype=torch.float64),
                 rs.ess(lws))
        (_, _, _, log_z, _), (flag,) = step(
            carry, (torch.as_tensor(ys), torch.tensor(8, dtype=torch.int32), 9))
        assert bool(flag) == fire
        s_in, w_in, t0 = seen[0]
        assert t0 == 9
        if fire:
            assert torch.equal(w_in, torch.zeros(n))
            lme = torch.logsumexp(lws.double(), 0) - math.log(n)
            np.testing.assert_allclose(float(log_z), -1.0 + float(lme), rtol=1e-12)
            heavy = np.argsort(lw)[-n // 8:]
            assert np.isin(s_in.numpy(), x[heavy]).mean() > 0.5
        else:
            assert torch.equal(s_in, xs) and torch.equal(w_in, lws)
            assert float(log_z) == -1.0


@pytest.mark.parametrize("which", ["hmm", "lg"])
def test_stratified_takes_the_ancestor_path(which, monkeypatch):
    """Only systematic resampling takes the exchange or streaming fast
    paths; a stratified request resamples by ancestors."""
    calls = []
    strat = rs.stratified_resample

    def spy(key, log_w, n_out=None):
        calls.append(1)
        return strat(key, log_w, n_out)

    def forbidden(*a, **k):
        raise AssertionError("fast path taken for stratified resampling")

    monkeypatch.setitem(rs._RESAMPLERS, "stratified", spy)
    monkeypatch.setattr(port_smc, "continuous_resample_values_lme", forbidden)
    monkeypatch.setattr(port_smc, "category_counts_systematic", forbidden)
    model = hmm_ssm if which == "hmm" else make_fused_lg_ssm()
    run = build_smc_run(model, 4096, resampling="stratified", ess_threshold=1.0)
    res = run(0, torch.as_tensor(OBS))
    assert len(calls) == 15 and bool(res.resampled[1:].all())
    assert np.isfinite(float(res.log_evidence))
    with pytest.raises(ValueError, match="systematic"):
        build_smc_run(model, 4096, resampling="stratified", chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 16) + 3, 1 << 20])
def test_step_ctrl_launch_matches_plain_on_card(n):
    """K6 with the step's resample control, flag off and on: bit-equal to
    the launch without control on the weights a reset leaves, a set flag
    reading no old weight, the ESS within 1e-12 of the combine of its own
    records, the next flag equal to the plain version's, the ticket left
    clean over repeated launches and on a second stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    assert chip_smoke.check_lg_step_ctrl(n) < 1e-3


@pytest.mark.cuda
def test_step_ctrl_counts_and_null_control_on_card():
    """A 16-step per-step sweep makes 15 launches with the step's control
    and none without it; a launch without control (``lg_step``) gives
    what it gave before: a one-step ``lg_chunk`` bit for bit, the plain
    version within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from cpprob_tpu_torch.util.profiling import counters

    dev = torch.device("cuda")
    obs = torch.as_tensor(OBS, device=dev)
    run = build_smc_run(make_fused_lg_ssm(), 1 << 16, chunk=1)
    run(0, obs)
    before = counters()
    res = run(1, obs)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in counters().items() if v != before[k]}
    assert moved["fused_lg.step_ctrl"] == 15 and "fused_lg.step" not in moved
    assert moved["fused_lg.init"] == 1 and moved["stream_resample.lse_stats"] == 16
    assert res.resampled.dtype == torch.bool and bool(res.resampled.any())
    x, w, _ = (torch.as_tensor(a, device=dev) for a in _population(9, 1 << 16))
    xs, ws = lg_step(5, x, w, obs[3], 3)
    xc, wc, _ = lg_chunk(5, x, w, obs[3:4], t0=3)
    xp, wp = lg_step_plain(5, x, w, obs[3], 3)
    assert torch.equal(xs, xc) and torch.equal(ws, wc)
    torch.testing.assert_close(ws, wp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs, xp, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 16) + 3, 1 << 24])
def test_init_launch_matches_plain_on_card(n):
    """The sweep's start: states and weights bit-equal to the plain
    version, the ESS within 1e-12 of the combine of its own records, the
    first flag right on either side of it, the ticket left clean, also on
    a second stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    assert chip_smoke.check_lg_init(n) == 0.0


@pytest.mark.cuda
def test_lg_kernel_and_epoch_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    errs = chip_smoke.check_lg_kernels(1 << 16)
    assert errs["lg_chunk"] < 1e-3 and errs["lse_stats"] < 1e-9
