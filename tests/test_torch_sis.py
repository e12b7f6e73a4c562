"""The port's SIS (``cpprob_tpu_torch.inference.sis``), its post-processing
(``postprocess``) and compensated sums (``util/numerics.py``) against the
JAX package's.

- Deterministic parts at 1e-6: ``ImportanceResult``,
  ``EmpiricalDistribution``, ``StatsPrinter.summary``, ``CompSum``, the
  streaming merge and the chain diagnostics are fed the same numpy arrays
  in both packages.
- Statistics: the estimates of ``tests/test_sis.py`` at 2^14-2^16
  particles, each held to the same oracle and to the JAX package's own
  estimate at the same N within 4 SE + floor (the rule of
  ``__graft_entry__.py``); an estimate's SE is the delta-method SE of its
  self-normalized importance weights, from the run itself.
- State carried across: a dump written by the JAX package's
  ``sis_streaming_checkpointed`` resumes in the port, and the reverse; a
  resumed port run equals an uninterrupted one bit for bit.
"""

import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

import cpprob_tpu as jt
import cpprob_tpu.models as jm
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.models as pm
from cpprob_tpu.postprocess import diagnostics as jdiag
from cpprob_tpu.util import numerics as jnum
from cpprob_tpu_torch.postprocess import diagnostics as pdiag
from cpprob_tpu_torch.util import numerics as pnum

# the packages' ``inference.sis`` attributes are functions, not the modules
jsis = importlib.import_module("cpprob_tpu.inference.sis")
psis = importlib.import_module("cpprob_tpu_torch.inference.sis")

torch.set_num_threads(2)

FLOOR = 0.02
README_MEAN, README_VAR = 2.32353, 1.05882
HMM_OBS = np.array([0.9, 0.8, 0.7, 0.0, -0.025, -5.0, -2.0, -0.1, 0.0, 0.13], np.float32)
LG_OBS = np.array([0.5, 1.0, 0.3, -0.2, 0.8], np.float32)
PTS = np.array([[1, 2.1], [2, 3.9], [3, 5.3], [4, 7.7], [5, 10.2], [6, 12.9]], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weights(res):
    lw = _np(res.log_weights).astype(np.float64)
    w = np.exp(lw - lw.max())
    return w / w.sum(), lw


def _moments(res, name):
    """Weighted mean and variance of a scalar predict, with their
    delta-method SEs."""
    w, _ = _weights(res)
    x = _np(res.predicts[name]).astype(np.float64)
    w_ = w.reshape(w.shape + (1,) * (x.ndim - 1))
    m = (w_ * x).sum(0)
    d2 = (x - m) ** 2
    v = (w_ * d2).sum(0)
    se_m = np.sqrt((w_ ** 2 * d2).sum(0))
    se_v = np.sqrt((w_ ** 2 * (d2 - v) ** 2).sum(0))
    return m, v, se_m, se_v


def _log_z(res):
    """log Z and its delta-method SE."""
    _, lw = _weights(res)
    big = np.exp(lw - lw.max())
    se = np.sqrt(big.var() / (len(big) * big.mean() ** 2))
    return float(np.log(big.mean()) + lw.max()), se


def _close(got, se_got, want, se_want, what, floor=FLOOR):
    got, want = np.asarray(got), np.asarray(want)
    tol = 4 * np.sqrt(np.asarray(se_got) ** 2 + np.asarray(se_want) ** 2) + floor
    assert np.all(np.abs(got - want) <= tol), (what, got, want, tol)


def _both(model_name, args, n, seed=0):
    port = pt.sis(getattr(pm, model_name), args, n, seed, device="cpu")
    ref = jt.sis(getattr(jm, model_name), args, n, jax.random.key(100 + seed))
    return port, ref


# --- statistics ------------------------------------------------------------


def _check_moments(port, ref, name, mean, var, floor_var=0.03):
    pm_, pv, pse_m, pse_v = _moments(port, name)
    jm_, jv, jse_m, jse_v = _moments(ref, name)
    _close(pm_, pse_m, mean, 0.0, f"{name} mean vs oracle")
    _close(pv, pse_v, var, 0.0, f"{name} variance vs oracle", floor_var)
    _close(pm_, pse_m, jm_, jse_m, f"{name} mean vs JAX")
    _close(pv, pse_v, jv, jse_v, f"{name} variance vs JAX", floor_var)
    # the result's own moments are the weighted ones above
    np.testing.assert_allclose(_np(port.mean(name)), pm_, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(port.variance(name)), pv, rtol=1e-3, atol=1e-5)


def test_gaussian_readme_constants():
    """The headline gate: posterior N(2.32353, 1.05882) for (3, 4)
    (README.md:100,118), and the analytic marginal likelihood."""
    port, ref = _both("gaussian_unknown_mean_readme", (3.0, 4.0), 1 << 16)
    _check_moments(port, ref, "Mean", README_MEAN, README_VAR)
    cov = np.array([[4.0 + 2.25, 2.25], [2.25, 4.0 + 2.25]])
    want = sps.multivariate_normal.logpdf([3.0, 4.0], [1.0, 1.0], cov)
    lz, se = _log_z(port)
    jlz, jse = _log_z(ref)
    _close(lz, se, want, 0.0, "log Z vs analytic")
    _close(lz, se, jlz, jse, "log Z vs JAX")
    np.testing.assert_allclose(float(port.log_evidence), lz, rtol=1e-5)


def test_gaussian_models_hpp_variant():
    port, ref = _both("gaussian_unknown_mean", (3.0, 4.0), 1 << 16)
    mean, var = pm.gaussian_posterior_analytic([3.0, 4.0])
    jmean, jvar = jm.gaussian_posterior_analytic([3.0, 4.0])
    np.testing.assert_allclose([mean, var], [float(jmean), float(jvar)], rtol=1e-6)
    _check_moments(port, ref, "Mu", mean, var)
    assert pt.sis(pm.Gauss(), (3.0, 4.0), 16, 0, device="cpu").log_weights.shape == (16,)


def test_gaussian_2d():
    port, ref = _both("gaussian_2d_unknown_mean", (np.array([3.0, 4.0], np.float32),), 1 << 16)
    v0 = np.array([5.0, 3.0])
    v = 1.0 / (1.0 / v0 + 1.0 / 2.0)
    m = v * (np.array([1.0, 2.0]) / v0 + np.array([3.0, 4.0]) / 2.0)
    _check_moments(port, ref, "Mu", m, v, floor_var=0.05)


def test_linear_gaussian_vs_kalman():
    port, ref = _both("linear_gaussian_1d", (LG_OBS,), 1 << 16)
    ms, ps, ll = pm.kalman_filter_1d(LG_OBS)
    jms, _, jll = jm.kalman_filter_1d(LG_OBS)
    np.testing.assert_allclose([ms[-1], ll], [float(jms[-1]), float(jll)], rtol=1e-5)
    m, _, se, _ = _moments(port, "State")
    jm_, _, jse, _ = _moments(ref, "State")
    _close(m[-1], se[-1], ms[-1], 0.0, "final state vs Kalman")
    _close(m, se, jm_, jse, "smoothed states vs JAX")
    lz, lse = _log_z(port)
    _close(lz, lse, ll, 0.0, "log Z vs Kalman")
    _close(lz, lse, _log_z(ref)[0], _log_z(ref)[1], "log Z vs JAX")


def _marginals(res):
    w, _ = _weights(res)
    states = _np(res.predicts["State"])
    est = np.stack([(w[:, None] * (states == s)).sum(0) for s in range(3)], 1)
    se = np.stack([np.sqrt((w[:, None] ** 2 * ((states == s) - est[:, s]) ** 2).sum(0))
                   for s in range(3)], 1)
    return est, se


@pytest.mark.parametrize("model", ["hmm", "hmm_scan"])
def test_hmm_posterior_vs_forward_backward(model):
    port, ref = _both(model, (HMM_OBS,), 1 << 16)
    exact = pm.hmm_exact_posterior(HMM_OBS)
    np.testing.assert_allclose(exact, np.asarray(jm.hmm_exact_posterior(HMM_OBS)), atol=1e-6)
    est, se = _marginals(port)
    jest, jse = _marginals(ref)
    _close(est, se, exact, 0.0, "marginals vs forward-backward")
    _close(est, se, jest, jse, "marginals vs JAX")
    assert port.predicts["State"].shape == (1 << 16, len(HMM_OBS))
    lz, lse = _log_z(port)
    _close(lz, lse, pm.hmm_log_evidence(HMM_OBS), 0.0, "log Z vs forward recursion")


def test_hmm_scan_fast_path_equals_unrolled():
    """Under the SIS stack ``hmm_scan`` takes the fast path (tied
    addresses), ``hmm`` unrolls: one draw order, so the same draws bit for
    bit, and the same log-weights but for the order of their sum (the fast
    path adds the loop's terms up first)."""
    a = pt.sis(pm.hmm, (HMM_OBS,), 4096, 3, device="cpu")
    b = pt.sis(pm.hmm_scan, (HMM_OBS,), 4096, 3, device="cpu")
    assert torch.equal(a.predicts["State"], b.predicts["State"])
    torch.testing.assert_close(a.log_weights, b.log_weights, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("model", ["normal_rejection_sampling", "normal_rejection_sampling_guard"])
def test_rejection_models(model):
    port, ref = _both(model, (3.0, 4.0), 1 << 15)
    mean, var = pm.gaussian_posterior_analytic([3.0, 4.0])
    _check_moments(port, ref, "Mu", mean, var)


def test_guard_model_thesis_variant():
    """(8, 9): mu | y ~ N(7.25, 5/6) — the prior's tail, where the guard's
    accepted-draw law matters."""
    port, ref = _both("normal_rejection_sampling_guard", (8.0, 9.0), 1 << 15)
    _check_moments(port, ref, "Mu", 7.25, 5.0 / 6.0, floor_var=0.05)


def test_linear_regression():
    port, ref = _both("linear_regression", (PTS,), 1 << 16)
    for name in ("a", "b"):
        m, _, se, _ = _moments(port, name)
        jm_, _, jse, _ = _moments(ref, name)
        _close(m, se, jm_, jse, name, floor=0.1)
    # the posterior concentrates near the OLS fit (slope ~2.16, intercept ~-0.52)
    assert abs(float(port.mean("a")) - 2.16) < 0.5
    assert abs(float(port.mean("b")) + 0.52) < 1.2


def test_poly_adjustment_and_all_distr_run():
    res = pt.sis(pm.poly_adjustment, (PTS[:3],), 4096, 0, device="cpu")
    assert res.predicts["Coefficient"].shape == (4096, 2)
    res = pt.sis(pm.all_distr, (0, 0), 4096, 0, device="cpu")
    assert bool(torch.isfinite(res.log_weights).all())
    ref = jt.sis(jm.all_distr, (0, 0), 64, jax.random.key(0))
    for k, v in ref.predicts.items():
        assert tuple(res.predicts[k].shape[1:]) == tuple(v.shape[1:]), k
        assert res.predicts[k].dtype.is_floating_point == jnp.issubdtype(v.dtype, jnp.floating), k


def test_batched_sis_draws_the_batches_in_turn():
    """``batch_size`` runs the batches one after the other from the one
    generator: the same particles as batch-sized calls on that generator."""
    n, b = 4096, 512
    res = pt.sis(pm.gaussian_unknown_mean, (3.0, 4.0), n,
                 torch.Generator().manual_seed(5), batch_size=b)
    g = torch.Generator().manual_seed(5)
    parts = [pt.sis(pm.gaussian_unknown_mean, (3.0, 4.0), b, g) for _ in range(n // b)]
    assert torch.equal(res.log_weights, torch.cat([p.log_weights for p in parts]))
    assert torch.equal(res.predicts["Mu"], torch.cat([p.predicts["Mu"] for p in parts]))
    whole = pt.sis(pm.gaussian_unknown_mean, (3.0, 4.0), n, 5, device="cpu", batch_size=n)
    assert torch.equal(whole.log_weights,
                       pt.sis(pm.gaussian_unknown_mean, (3.0, 4.0), n, 5, device="cpu").log_weights)
    with pytest.raises(ValueError, match="divisible"):
        pt.sis(pm.gaussian_unknown_mean, (3.0, 4.0), n, 5, device="cpu", batch_size=300)


def test_ess_and_stats_printer(tmp_path):
    from cpprob_tpu_torch.io import dump_posterior

    res = pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 10_000, 0, device="cpu")
    assert 0 < float(res.ess) <= 10_000
    text = pt.StatsPrinter(res).print()
    assert "Mean" in text
    # from_dump (slice 5): a dump of the result summarizes as the result does
    path = str(tmp_path / "posterior")
    dump_posterior(path, res)
    got = pt.StatsPrinter.from_dump(path).summary()["Mean"]
    want = pt.StatsPrinter(res).summary()["Mean"]
    assert got["kind"] == "real" and got["count"] == 10_000
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5)
    np.testing.assert_allclose(got["variance"], want["variance"], rtol=1e-4)


# --- streaming and checkpoints -------------------------------------------------


def test_streaming_matches_batch():
    """A generator key draws the chunks in turn from itself, so the
    streaming sums see the particles that ``sis(batch_size=)`` keeps."""
    res = pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 65536,
                 torch.Generator().manual_seed(1), batch_size=4096)
    stream = psis.sis_streaming(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 65536,
                                torch.Generator().manual_seed(1), batch_size=4096)
    np.testing.assert_allclose(float(stream.mean("Mean")), float(res.mean("Mean")), rtol=1e-4)
    np.testing.assert_allclose(float(stream.variance("Mean")), float(res.variance("Mean")),
                               rtol=1e-3)
    np.testing.assert_allclose(float(stream.log_evidence), float(res.log_evidence), rtol=1e-4)
    np.testing.assert_allclose(float(stream.ess), float(res.ess), rtol=1e-3)


def test_streaming_hmm_vector_predicts():
    obs = np.array([0.9, 0.8, -1.0], np.float32)
    res = pt.sis(pm.hmm, (obs,), 16384, torch.Generator().manual_seed(2), batch_size=2048)
    stream = psis.sis_streaming(pm.hmm, (obs,), 16384, torch.Generator().manual_seed(2),
                                batch_size=2048)
    np.testing.assert_allclose(_np(stream.mean("State")), _np(res.mean("State")), atol=1e-3)


def test_streaming_checkpointed_matches_and_resumes(tmp_path):
    args = (pm.gaussian_unknown_mean_readme, (3.0, 4.0), 32768, 11)
    dump = str(tmp_path / "partial.npz")
    stream = psis.sis_streaming(*args, 2048, device="cpu")
    ck = psis.sis_streaming_checkpointed(*args, 2048, dump, dump_every=4, device="cpu")
    assert torch.equal(ck.log_evidence, stream.log_evidence)
    assert torch.equal(ck.mean("Mean"), stream.mean("Mean"))
    with np.load(dump) as full:
        assert int(full["chunks_done"]) == 16

    # a genuine interruption right after the second dump, then a resume
    # from the mid-run checkpoint: bit-identical
    dump2 = str(tmp_path / "interrupted.npz")
    real_replace, calls = os.replace, {"n": 0}

    def dying_replace(src, dst):
        real_replace(src, dst)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    os.replace = dying_replace
    try:
        with pytest.raises(KeyboardInterrupt):
            psis.sis_streaming_checkpointed(*args, 2048, dump2, dump_every=4, device="cpu")
    finally:
        os.replace = real_replace
    with np.load(dump2) as mid:
        assert int(mid["chunks_done"]) == 8
    resumed = psis.sis_streaming_checkpointed(*args, 2048, dump2, dump_every=4,
                                              device="cpu", resume=True)
    assert torch.equal(resumed.log_evidence, ck.log_evidence)
    assert torch.equal(resumed.variance("Mean"), ck.variance("Mean"))
    _close(float(ck.mean("Mean")), 0.01, README_MEAN, 0.0, "checkpointed mean")


def test_streaming_checkpointed_rejects_mismatched_shape(tmp_path):
    dump = str(tmp_path / "p.npz")
    m = pm.gaussian_unknown_mean_readme
    psis.sis_streaming_checkpointed(m, (3.0, 4.0), 8192, 0, 2048, dump, device="cpu")
    with pytest.raises(ValueError, match="written for"):
        psis.sis_streaming_checkpointed(m, (3.0, 4.0), 16384, 0, 2048, dump, device="cpu")
    with pytest.raises(TypeError, match="integer seed"):
        psis.sis_streaming_checkpointed(m, (3.0, 4.0), 8192, torch.Generator(), 2048, dump)


def _carry_arrays(carry):
    m, s0, s0_sq, sums, sqs = carry
    out = {"m": m, "s0": s0.value, "s0#c": s0.comp, "s0_sq": s0_sq.value,
           "s0_sq#c": s0_sq.comp}
    for k in sums:
        out[f"sum:{k}"], out[f"sum:{k}#c"] = sums[k].value, sums[k].comp
        out[f"sq:{k}"], out[f"sq:{k}#c"] = sqs[k].value, sqs[k].comp
    return {k: _np(v) for k, v in out.items()}


def test_checkpoint_carried_across_packages(tmp_path):
    """A dump of the JAX package resumes in the port's carry (within 1e-7),
    and one of the port's in the JAX package: a finished dump finalizes to
    the writer's own result."""
    obs = np.array([0.9, 0.8, -1.0], np.float32)
    n, b = 8192, 2048
    jdump = str(tmp_path / "jax.npz")
    jres = jsis.sis_streaming_checkpointed(jm.hmm, (obs,), n, jax.random.key(0), b, jdump)
    carry, done = psis.load_checkpoint(jdump, n, b, "cpu")
    assert done == n // b
    with np.load(jdump) as ck:
        got = _carry_arrays(carry)
        assert sorted(got) == sorted(k for k in ck.files if k not in
                                     ("chunks_done", "batch_size", "n_particles"))
        for k, v in got.items():
            np.testing.assert_allclose(v, ck[k], rtol=1e-7, atol=0, err_msg=k)
    pres = psis.sis_streaming_checkpointed(pm.hmm, (obs,), n, 0, b, jdump, device="cpu")
    np.testing.assert_allclose(float(pres.log_evidence), float(jres.log_evidence), rtol=1e-6)
    np.testing.assert_allclose(_np(pres.mean("State")), np.asarray(jres.mean("State")),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(pres.variance("State")),
                               np.asarray(jres.variance("State")), rtol=1e-5, atol=1e-6)

    pdump = str(tmp_path / "port.npz")
    pres = psis.sis_streaming_checkpointed(pm.hmm, (obs,), n, 4, b, pdump, device="cpu")
    jres = jsis.sis_streaming_checkpointed(jm.hmm, (obs,), n, jax.random.key(9), b, pdump)
    np.testing.assert_allclose(float(jres.log_evidence), float(pres.log_evidence), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jres.mean("State")), _np(pres.mean("State")),
                               rtol=1e-6)
    np.testing.assert_allclose(float(jres.ess), float(pres.ess), rtol=1e-6)


def test_port_resumes_a_jax_run_midway(tmp_path):
    """A JAX run stopped after two of four chunks finishes in the port."""
    obs = np.array([0.9, 0.8, -1.0], np.float32)
    dump = str(tmp_path / "mid.npz")
    jsis.sis_streaming_checkpointed(jm.hmm, (obs,), 4096, jax.random.key(0), 1024, dump,
                                    dump_every=2)
    with np.load(dump) as ck:
        payload = {k: ck[k] for k in ck.files}
    payload["chunks_done"] = np.asarray(2)
    payload["n_particles"] = np.asarray(4096)
    # the same carry, declared two chunks short of a run of 4096
    np.savez(dump, **payload)
    res = psis.sis_streaming_checkpointed(pm.hmm, (obs,), 4096, 1, 1024, dump, device="cpu")
    with np.load(dump) as ck:
        assert int(ck["chunks_done"]) == 4
    assert math.isfinite(float(res.log_evidence))
    exact = pm.hmm_exact_posterior(obs)
    assert np.abs(_np(res.mean("State")) - (exact * np.arange(3)).sum(1)).max() < 0.15


# --- deterministic parts --------------------------------------------------------


def _arrays(seed=0, n=4096):
    rng = np.random.RandomState(seed)
    lw = (2.0 * rng.normal(size=n)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    xv = rng.normal(size=(n, 3)).astype(np.float32)
    k = rng.randint(0, 4, size=(n, 2)).astype(np.int32)
    return lw, x, xv, k


def test_importance_result_matches_reference():
    lw, x, xv, k = _arrays()
    p = psis.ImportanceResult(torch.as_tensor(lw), {"x": torch.as_tensor(x),
                                                    "v": torch.as_tensor(xv)})
    j = jsis.ImportanceResult(jnp.asarray(lw), {"x": jnp.asarray(x), "v": jnp.asarray(xv)})
    c = lambda a, b: np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    c(p.normalized_weights, j.normalized_weights)
    c(p.log_evidence, j.log_evidence)
    c(p.ess, j.ess)
    for name in ("x", "v"):
        c(p.mean(name), j.mean(name))
        np.testing.assert_allclose(_np(p.variance(name)), np.asarray(j.variance(name)),
                                   rtol=1e-5, atol=1e-7)
    assert p.num_particles == j.num_particles == 4096


def test_empirical_distribution_matches_reference():
    from cpprob_tpu.postprocess import EmpiricalDistribution as JE

    lw, x, xv, k = _arrays(1)
    for vals in (x, xv, k):
        p = pt.EmpiricalDistribution(torch.as_tensor(vals), torch.as_tensor(lw))
        j = JE(jnp.asarray(vals), jnp.asarray(lw))
        for attr in ("mean", "variance", "std", "ess"):
            np.testing.assert_allclose(_np(getattr(p, attr)), np.asarray(getattr(j, attr)),
                                       rtol=1e-5, atol=1e-6, err_msg=attr)
    p = pt.EmpiricalDistribution(torch.as_tensor(k), torch.as_tensor(lw))
    j = JE(jnp.asarray(k), jnp.asarray(lw))
    for num in (3, 4, 6):   # 3: values outside the support count for none
        np.testing.assert_allclose(_np(p.distribution(num)), np.asarray(j.distribution(num)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(_np(p.map_estimate(num)), np.asarray(j.map_estimate(num)))


def test_stats_printer_summary_matches_reference():
    lw, x, xv, k = _arrays(2)
    p = pt.StatsPrinter(psis.ImportanceResult(
        torch.as_tensor(lw), {"x": torch.as_tensor(x), "k": torch.as_tensor(k.astype(np.int64))}))
    j = jt.StatsPrinter(jsis.ImportanceResult(
        jnp.asarray(lw), {"x": jnp.asarray(x), "k": jnp.asarray(k)}))
    ps, js = p.summary(), j.summary()
    assert ps.keys() == js.keys()
    for name in ps:
        assert ps[name]["kind"] == js[name]["kind"] and ps[name]["count"] == js[name]["count"]
        for key, v in js[name].items():
            if key not in ("kind", "count"):
                np.testing.assert_allclose(ps[name][key], v, rtol=1e-5, atol=1e-6)
    assert p.print() .count("\n") == j.print().count("\n")


def test_compensated_sums_match_reference():
    rng = np.random.RandomState(3)
    xs = rng.uniform(size=4096).astype(np.float32) * 1e-3
    p, j = pnum.comp_zero(torch.zeros(())), jnum.comp_zero(jnp.zeros(()))
    for i, v in enumerate(xs):
        p, j = pnum.comp_add(p, torch.tensor(v)), jnum.comp_add(j, v)
        if i % 1024 == 1023:
            p, j = pnum.comp_scale(p, 0.5), jnum.comp_scale(j, 0.5)
    np.testing.assert_allclose(_np(p.value), np.asarray(j.value), rtol=1e-6)
    np.testing.assert_allclose(float(pnum.comp_value(p)), float(jnum.comp_value(j)), rtol=1e-6)
    exact = 0.0
    for i, v in enumerate(xs):
        exact += float(v)
        if i % 1024 == 1023:
            exact *= 0.5
    # the compensated sum within float32 rounding of the exact one
    assert abs(float(pnum.comp_value(p)) - exact) <= 4 * np.finfo(np.float32).eps * exact


def _chunks(n_chunks=6, size=512):
    rng = np.random.RandomState(4)
    out = []
    for c in range(n_chunks):
        lw = (rng.normal(size=size) * 3 - c).astype(np.float32)
        vals = {"x": rng.normal(size=size).astype(np.float32),
                "v": rng.normal(size=(size, 2)).astype(np.float32)}
        m = lw.max()
        w = np.exp(lw - m)
        sums = {k: (w.reshape((-1,) + (1,) * (v.ndim - 1)) * v).sum(0) for k, v in vals.items()}
        sqs = {k: (w.reshape((-1,) + (1,) * (v.ndim - 1)) * v * v).sum(0)
               for k, v in vals.items()}
        out.append((np.float32(m), np.float32(w.sum()), np.float32((w * w).sum()),
                    {k: v.astype(np.float32) for k, v in sums.items()},
                    {k: v.astype(np.float32) for k, v in sqs.items()}))
    return out


def _map(chunk, fn):
    m, s0, s0_sq, sums, sqs = chunk
    return (fn(m), fn(s0), fn(s0_sq), {k: fn(v) for k, v in sums.items()},
            {k: fn(v) for k, v in sqs.items()})


def test_streaming_merge_matches_reference():
    chunks = _chunks()
    pc = psis._lift_chunk(_map(chunks[0], torch.as_tensor))
    jc = jsis._lift_chunk(_map(chunks[0], jnp.asarray))
    for ch in chunks[1:]:
        pc = psis._merge_stats(pc, _map(ch, torch.as_tensor))
        jc = jsis._merge_stats(jc, _map(ch, jnp.asarray))
    pa, ja = _carry_arrays(pc), _carry_arrays(jc)
    for k in ja:
        if k.endswith("#c"):
            # a compensation term is a rounding error of its sum: held to
            # two float32 ulps of the sum (the two exps may differ by one)
            atol = 2 * np.finfo(np.float32).eps * np.abs(ja[k[:-2]]).max()
            np.testing.assert_allclose(pa[k], ja[k], rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(pa[k], ja[k], rtol=1e-6, atol=1e-7, err_msg=k)
    p, j = psis._finalize_stats(pc, 3072), jsis._finalize_stats(jc, 3072)
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    for d_p, d_j in zip(p[2:], j[2:]):
        for k in d_j:
            np.testing.assert_allclose(_np(d_p[k]), np.asarray(d_j[k]), rtol=1e-5, atol=1e-6)


def test_chain_diagnostics_match_reference():
    rng = np.random.RandomState(5)
    x = np.cumsum(rng.normal(size=(4, 400, 2)), axis=1).astype(np.float32) * 0.1 \
        + rng.normal(size=(4, 400, 2)).astype(np.float32)
    c = lambda a, b: np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # jitted: the reference's op-by-op lag loop compiles one program a lag
    j_ess = jax.jit(jdiag.effective_sample_size, static_argnums=1)
    c(pdiag.split_rhat(torch.as_tensor(x)), jdiag.split_rhat(jnp.asarray(x)))
    for lag in (100, 7):
        c(pdiag.effective_sample_size(torch.as_tensor(x), lag), j_ess(jnp.asarray(x), lag))
    ps = pdiag.summarize_chains(torch.as_tensor(x))
    js = jax.jit(jdiag.summarize_chains)(jnp.asarray(x))
    for k in js:
        c(ps[k], js[k])


@pytest.mark.cuda
def test_sis_on_the_card():
    """The README model on the card, under sync-debug "error": the call
    never waits on the host (``chip_smoke.py``'s SIS phase holds the rest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 1 << 16, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 1 << 20, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.log_weights.device.type == "cuda"
    assert abs(float(res.mean("Mean")) - README_MEAN) < 0.02


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``util/profiling.profile_trace``, the reference's ``jax.profiler``
    wrapper, over a CPU SIS call and an SMC query: a Chrome trace with the
    calls' operators and the query's spans."""
    import json

    from cpprob_tpu_torch.models.linear_gaussian import (
        linear_gaussian_ssm,
        simulate_observations,
    )
    from cpprob_tpu_torch.util.profiling import profile_trace

    obs = torch.as_tensor(simulate_observations(4, 0))
    with profile_trace(str(tmp_path)) as prof:
        pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 256, 0, device="cpu")
        pt.build_smc_run(linear_gaussian_ssm, 256)(0, obs)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::randn" in names or "aten::normal_" in names, sorted(names)[:20]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"smc.run", "smc.init", "smc.step", "resample.epoch"} <= spans, spans
    assert len(prof.key_averages()) > 0
