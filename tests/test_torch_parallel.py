"""The port's multi-device layer (``cpprob_tpu_torch.parallel``, the
``mesh=`` paths of ``CSIS``, ``entry.dryrun_multichip``) on four gloo CPU
ranks, held against the JAX package's ``parallel/`` under ``shard_map``
on four of the conftest's virtual devices.

The port's side runs in two launches of four worker processes
(``_torch_parallel_worker.py``, one ``file://`` store each, every launch
with its own timeout); each writes an npz a rank that the parametrised
cases read.  The inputs come from the numpy seeds the worker names.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as W

from cpprob_tpu.models import hmm_ssm as ref_hmm_ssm
from cpprob_tpu.models import linear_gaussian_ssm as ref_lg_ssm
from cpprob_tpu.parallel import resampling as ref_res
from cpprob_tpu.parallel import smc_sharded as ref_smc_sharded
from cpprob_tpu_torch.inference.csis import CSIS
from cpprob_tpu_torch.models import (
    HMM_MEANS,
    gaussian_posterior_analytic,
    gaussian_unknown_mean,
    gaussian_unknown_mean_readme,
    hmm_log_evidence,
    kalman_filter_1d,
)
from cpprob_tpu_torch.parallel import (
    initialize_multihost,
    is_multihost,
    particle_mesh,
    particle_sharding,
    replicated_sharding,
    sis_sharded,
    virtual_devices,
)
from cpprob_tpu_torch.util.pytree import tree_leaves

K = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
TIMEOUT = 240      # seconds, each worker
HALF_LOG_2PI = 0.9189385332046727


def _launch(job, tmp, world=K):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / f"store_{job}"), str(tmp), job],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _collect(procs, tmp, job):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"[{r}] OK" in out, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(tmp / f"{job}_{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    procs = {job: _launch(job, tmp) for job in ("resample", "engines")}
    procs["pair"] = _launch("pair", tmp, world=2)
    return tmp, procs


@pytest.fixture(scope="module")
def resample(launches):
    tmp, procs = launches
    return _collect(procs["resample"], tmp, "resample")


@pytest.fixture(scope="module")
def engines(launches):
    tmp, procs = launches
    return _collect(procs["engines"], tmp, "engines")


@pytest.fixture(scope="module")
def pair(launches):
    tmp, procs = launches
    return _collect(procs["pair"], tmp, "pair")


@pytest.fixture(scope="module")
def ref_mesh():
    devs = jax.devices()
    if len(devs) < K:
        pytest.skip(f"needs {K} virtual devices")
    return Mesh(np.asarray(devs[:K]), ("particles",))


def _shard_map(mesh, body, n_in, out_spec=P("particles")):
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("particles"),) * n_in,
                                 out_specs=out_spec, check_vma=False))


def _cat(runs, key):
    return np.concatenate([r[key] for r in runs])


def _same_on_all_ranks(runs, key):
    for r in runs[1:]:
        np.testing.assert_array_equal(r[key], runs[0][key], err_msg=key)
    return runs[0][key]


# --------------------------------------------------------------------------
# resampling


@pytest.mark.parametrize("spread", W.SPREADS)
def test_global_ess_and_log_mean_exp_match_reference(resample, ref_mesh, spread):
    """Against a float64 numpy oracle within 1e-12, and against the
    reference within rtol 1e-6; the reference's float32 log-mean-exp sums
    terms as large as log N, so its absolute error reaches two of their
    ulps (~1.9e-6), which bounds the comparison near 0."""
    w64 = W.spread_weights(spread, K).astype(np.float64)
    m = w64.max()
    e = np.exp(w64 - m)
    oracle = {"ess": e.sum() ** 2 / (e * e).sum(), "lme": m + np.log(e.mean())}
    lw = jnp.asarray(W.spread_weights(spread, K))
    atol = {"ess": 0.0, "lme": 2 * float(np.spacing(np.float32(np.log(w64.size))))}
    for name, fn in (("ess", ref_res.global_ess), ("lme", ref_res.global_log_mean_exp)):
        want = _shard_map(ref_mesh, lambda x: fn(x, "particles"), 1, P())(lw)
        got = _same_on_all_ranks(resample, f"{name}_{spread}")
        np.testing.assert_allclose(got, oracle[name], rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(got, float(want), rtol=1e-6, atol=atol[name],
                                   err_msg=name)


# slots where the float32 reference's ancestor differs from the float64
# port's, by u0: the comb positions of slots 3854 and 3992 lie 6.7e-9 and
# 1.4e-8 from a CDF boundary at u0 = 0.3781, inside float32's rounding
REF_DIFFERS = (0, 2, 0)


def _oracle_ancestors(u0):
    """Global and island ancestors by numpy float64 inverse CDF."""
    lw = W.resample_inputs(K)[0].astype(np.float64)
    n = lw.size
    cdf = np.cumsum(np.exp(lw - lw.max()))
    cdf /= cdf[-1]
    p = (np.arange(n) + u0) / n
    glob = np.clip(np.searchsorted(cdf, p, side="right"), 0, n - 1)
    loc = []
    for r in range(K):
        part = lw[r * W.N_LOCAL:(r + 1) * W.N_LOCAL]
        c = np.cumsum(np.exp(part - part.max()))
        c /= c[-1]
        u = np.mod(u0 + r * 0.6180339887, 1.0)
        loc.append(np.clip(np.searchsorted(c, (u + np.arange(W.N_LOCAL)) / W.N_LOCAL,
                                           side="right"), 0, W.N_LOCAL - 1))
    return glob, np.concatenate(loc), cdf, p


@pytest.mark.parametrize("i", range(len(W.U0S)))
def test_ancestors_and_ring_match_reference(resample, ref_mesh, i):
    """The port equals a float64 oracle slot for slot.  The float32
    reference equals the port except in ``REF_DIFFERS[i]`` slots, each a
    comb position within 1e-7 of a CDF boundary (float32's rounding)."""
    glob, loc, cdf, p = _oracle_ancestors(W.U0S[i])
    _, s1, s2, _ = W.resample_inputs(K)
    anc = _cat(resample, f"anc_{i}")
    np.testing.assert_array_equal(anc, glob)
    np.testing.assert_array_equal(_cat(resample, f"local_{i}"), loc)
    np.testing.assert_array_equal(_cat(resample, f"ring1_{i}"), s1[glob])
    np.testing.assert_array_equal(_cat(resample, f"ring2_{i}"), s2[glob])

    u0 = jnp.float32(W.U0S[i])
    lw = jnp.asarray(W.resample_inputs(K)[0])
    ref = np.asarray(_shard_map(ref_mesh, lambda w: ref_res.sharded_systematic_ancestors(
        u0, w, "particles"), 1)(lw))
    differ = np.nonzero(ref != anc)[0]
    assert differ.size == REF_DIFFERS[i], differ
    for j in differ:
        assert min(abs(p[j] - cdf[anc[j]]), abs(p[j] - cdf[anc[j] - 1])) < 1e-7, j
    ref_loc = _shard_map(ref_mesh, lambda w: ref_res.local_systematic_ancestors(
        u0, w, "particles"), 1)(lw)
    np.testing.assert_array_equal(_cat(resample, f"local_{i}"), np.asarray(ref_loc))
    for name, states in (("ring1", s1), ("ring2", s2)):
        ring = _shard_map(ref_mesh, lambda w, s: ref_res.ring_systematic_resample(
            u0, w, s, "particles"), 2)(lw, jnp.asarray(states))
        same = np.asarray(ring) == _cat(resample, f"{name}_{i}")
        rows = np.nonzero(~same.reshape(same.shape[0], -1).all(1))[0]
        np.testing.assert_array_equal(rows, differ)


@pytest.mark.parametrize("i", range(len(W.U0S)))
def test_balanced_equals_ring_bit_for_bit(resample, i):
    for dims in ("1", "2"):
        np.testing.assert_array_equal(_cat(resample, f"bal{dims}_{i}"),
                                      _cat(resample, f"ring{dims}_{i}"))
    for r in resample:          # one host read: the fit check
        assert int(r[f"bal_reads_{i}"]) == 1


def test_balanced_tree_states_equal_ring(resample, ref_mesh):
    assert all(bool(r["tree_equal"]) for r in resample)
    lw = jnp.asarray(W.resample_inputs(K)[0])
    anc = _shard_map(ref_mesh, lambda w: ref_res.sharded_systematic_ancestors(
        jnp.float32(0.42), w, "particles"), 1)(lw)
    np.testing.assert_array_equal(_cat(resample, "tree_i"), np.asarray(anc))


def test_balanced_fallback_and_fault_f2(resample, ref_mesh):
    """All the weight on shard 2: bound 16 does not fit, so the balanced
    scheme runs the exact ring; with ``fallback="none"`` the port raises
    (F2), where the reference returns a corrupt population silently."""
    ring, bal = _cat(resample, "conc_ring"), _cat(resample, "conc_bal")
    np.testing.assert_array_equal(bal, ring)
    assert ((ring >= 2 * W.N_LOCAL) & (ring < 3 * W.N_LOCAL)).all()
    for r in resample:
        msg = str(r["conc_none"])
        assert msg.startswith("ValueError") and "bound=16" in msg, msg
        assert str(r["bad_fallback"]).startswith("ValueError")
    conc = jnp.asarray(W.resample_inputs(K)[3])
    idx = jnp.arange(K * W.N_LOCAL, dtype=jnp.float32)
    ref_none = _shard_map(ref_mesh, lambda w, s: ref_res.balanced_systematic_resample(
        jnp.float32(0.9), w, s, "particles", bound=16, fallback="none"), 2)(conc, idx)
    assert not np.array_equal(np.asarray(ref_none), ring)       # the reference's fault


# --------------------------------------------------------------------------
# smc_sharded


def _xla_chunk(key_, states, log_w, ys, n_valid):
    """The reference test's stand-in for its Pallas chunk kernel."""
    def body(carry, inp):
        x, w = carry
        y, i = inp
        nx = x + jax.random.normal(jax.random.fold_in(key_, i), x.shape)
        d = y - nx
        valid = i < n_valid
        return (jnp.where(valid, nx, x),
                jnp.where(valid, w + (-0.5 * d * d - HALF_LOG_2PI), w)), None

    (x, w), _ = jax.lax.scan(body, (states, log_w),
                             (ys, jnp.arange(ys.shape[0], dtype=jnp.int32)))
    p = jax.nn.softmax(w)
    return x, w, 1.0 / jnp.sum(p * p)


_REF_CHUNK_SSM = dataclasses.replace(ref_lg_ssm, fused_chunk_batch=_xla_chunk)

# name -> (exact oracle, the reference's model, its obs, N, kwargs) or None
_LG = ("lg", ref_lg_ssm, W.N_SMC)
_SMC = {
    "step_collective": (_LG, dict(scheme="collective", track_fn=lambda x: x)),
    "step_balanced": None,
    "step_island": (_LG, dict(scheme="island")),
    "chunk_collective": (("lg", _REF_CHUNK_SSM, W.N_SMC), dict(scheme="collective", chunk=4)),
    "chunk_balanced": None,
    "chunk_island": (("lg", _REF_CHUNK_SSM, W.N_SMC), dict(scheme="island", chunk=4)),
    "hmm_exchange": (("hmm", ref_hmm_ssm, W.N_HMM), dict(scheme="exchange",
                                                          ess_threshold=1.0)),
    "hmm_island": (("hmm", ref_hmm_ssm, W.N_HMM), dict(scheme="island", ess_threshold=1.0)),
    "hmm_collective": (("hmm", ref_hmm_ssm, W.N_HMM), dict(
        scheme="collective", ess_threshold=1.0,
        track_fn=lambda z: jnp.asarray(HMM_MEANS)[z])),
}


def _exact(kind):
    if kind == "lg":
        return float(kalman_filter_1d(W.lg_observations())[2])
    return float(hmm_log_evidence(W.hmm_observations()))


@pytest.fixture(scope="module")
def ref_smc(ref_mesh):
    """The reference's ``smc_sharded`` at the port's N, over 4 seeds a
    configuration (one compile each: the seed is a traced argument)."""
    cache = {}

    def get(name):
        if name not in cache:
            (kind, model, n), kw = _SMC[name]
            obs = jnp.asarray(W.lg_observations() if kind == "lg" else W.hmm_observations())
            run = jax.jit(lambda key: ref_smc_sharded(model, obs, n, key, mesh=ref_mesh,
                                                      **kw))
            cache[name] = [run(jax.random.key(100 + s)) for s in range(W.SEEDS)]
        return cache[name]

    return get


def _stats(zs):
    return float(np.mean(zs)), float(np.std(zs, ddof=1) / np.sqrt(len(zs)))


@pytest.mark.parametrize("name", list(_SMC))
def test_smc_sharded_evidence(engines, ref_smc, name):
    """Replicated evidence; within 4 SE + 0.02 of the exact value (island:
    + 0.04, its Jensen gap); against the reference's sweep at the same N
    within 4 combined SE + 0.02."""
    zs = _same_on_all_ranks(engines, f"{name}_lz")
    kind = "hmm" if name.startswith("hmm") else "lg"
    mean, se = _stats(zs)
    floor = 0.04 if "island" in name else 0.02
    assert abs(mean - _exact(kind)) < 4 * se + floor, (mean, se, _exact(kind))
    assert all(int(r[f"{name}_epochs"][0]) >= 1 for r in engines)
    if _SMC[name] is not None:
        ref = [float(r.log_evidence) for r in ref_smc(name)]
        rmean, rse = _stats(ref)
        assert abs(mean - rmean) < 4 * (se + rse) + floor, (mean, se, rmean, rse)


@pytest.mark.parametrize("path", ["step", "chunk"])
def test_smc_sharded_balanced_equals_collective(engines, path):
    b, c = f"{path}_balanced", f"{path}_collective"
    for r in engines:
        np.testing.assert_array_equal(r[f"{b}_lz"], r[f"{c}_lz"])
        np.testing.assert_array_equal(r[f"{b}_states0"], r[f"{c}_states0"])
        np.testing.assert_array_equal(r[f"{b}_lw0"], r[f"{c}_lw0"])
        np.testing.assert_array_equal(r[f"{b}_ess0"], r[f"{c}_ess0"])


@pytest.mark.parametrize("name", ["step_collective", "hmm_collective"])
def test_smc_sharded_tracked_means_match_reference(engines, ref_smc, name):
    got = _same_on_all_ranks(engines, f"{name}_tracked").mean(0)
    ref = np.mean([np.asarray(r.tracked) for r in ref_smc(name)], axis=0)
    np.testing.assert_allclose(got, ref, atol=0.08)
    if name == "step_collective":
        ms = np.asarray(kalman_filter_1d(W.lg_observations())[0])[1:]
        np.testing.assert_allclose(got, ms, atol=0.1)


@pytest.mark.parametrize("name", ["scheme", "exchange_categories", "chunk_hook",
                                  "chunk_track", "exchange_chunk", "divide", "sis_divide"])
def test_smc_sharded_validation(engines, name):
    for r in engines:
        assert str(r[f"err_{name}"]).startswith("ValueError"), str(r[f"err_{name}"])


def test_exchange_chunked_fault_f11(ref_mesh):
    """The reference takes ``scheme="exchange"`` with ``chunk`` > 1 and runs
    island resampling in its place (F11): on the same model and key its
    "exchange" sweep equals its island sweep bit for bit.  The port raises
    (the case above)."""
    disc = dataclasses.replace(_REF_CHUNK_SSM, state_categories=3)
    ys = jnp.asarray(W.lg_observations())
    exchange, island = (ref_smc_sharded(disc, ys, W.N_SMC, jax.random.key(0),
                                        mesh=ref_mesh, scheme=s, chunk=4)
                        for s in ("exchange", "island"))
    assert np.isfinite(float(exchange.log_evidence))
    assert np.asarray(island.resampled).any()   # resampling ran: the schemes differ there
    assert float(exchange.log_evidence) == float(island.log_evidence)
    np.testing.assert_array_equal(np.asarray(exchange.final_states),
                                  np.asarray(island.final_states))
    np.testing.assert_array_equal(np.asarray(exchange.resampled),
                                  np.asarray(island.resampled))


# --------------------------------------------------------------------------
# sis_sharded, CSIS over a mesh, the dry run


def test_sis_sharded_against_analytic(engines):
    mu, var, ess, lz, n = _same_on_all_ranks(engines, "sis")
    assert n == 4096 * K
    mean_t, var_t = gaussian_posterior_analytic([3.0, 4.0])
    assert abs(mu - mean_t) < 4 * np.sqrt(var_t / ess) + 0.005
    assert abs(var - var_t) < 0.05
    lw = _cat(engines, "sis_local_lw").astype(np.float64)
    m = lw.max()
    np.testing.assert_allclose(lz, m + np.log(np.mean(np.exp(lw - m))), rtol=1e-9)
    w = np.exp(lw - m)
    np.testing.assert_allclose(mu, np.sum(w * _cat(engines, "sis_local_mu")) / w.sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(_cat(engines, "sis_nw").sum(), 1.0, rtol=1e-9)
    # the gathered empirical is the concatenation of the shards, on every rank
    np.testing.assert_array_equal(_same_on_all_ranks(engines, "sis_emp_values"),
                                  _cat(engines, "sis_local_mu"))
    np.testing.assert_array_equal(_same_on_all_ranks(engines, "sis_emp_lw"),
                                  _cat(engines, "sis_local_lw"))
    emp_mean = float(_same_on_all_ranks(engines, "sis_emp_mean"))
    np.testing.assert_allclose(emp_mean, mu, rtol=1e-5)
    # and its mean agrees with the reference's global empirical within 4 SE
    from cpprob_tpu.models import gaussian_unknown_mean as ref_gum
    from cpprob_tpu.parallel import particle_mesh as ref_particle_mesh
    from cpprob_tpu.parallel import sis_sharded as ref_sis_sharded

    ref = ref_sis_sharded(ref_gum, (3.0, 4.0), 4096 * K, jax.random.key(2),
                          mesh=ref_particle_mesh(K))
    ref_emp = ref.empirical("Mu")
    se = np.sqrt(var_t / ess) + np.sqrt(var_t / float(ref.ess))
    assert abs(emp_mean - float(ref_emp.mean)) < 4 * se, (emp_mean, float(ref_emp.mean))


def test_csis_data_parallel_step_equals_single_process(engines):
    """One step on a pinned batch of 64 traces, 16 a rank: the averaged
    gradient's Adam step equals the single process's on the whole batch."""
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=8, device="cpu")
    values, obs = eng._gen(torch.Generator().manual_seed(5), 16 * K)
    np.testing.assert_array_equal(obs.numpy(), engines[0]["dp_batch_obs"])
    params, losses = eng._train(eng.init(0), 1e-3, iter([(values, obs)]), None, None, 1)
    flat = np.concatenate([t.reshape(-1).numpy() for t in tree_leaves(params)])
    got = _same_on_all_ranks(engines, "dp_params")
    np.testing.assert_allclose(got, flat, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_same_on_all_ranks(engines, "dp_loss"), losses.numpy(),
                               rtol=1e-6)


def test_sharded_smc_chunked_balanced(engines):
    """The reference's ``test_sharded_smc_chunked_balanced``: a model that
    brings its own chunk hook without absolute time (plain PyTorch, the
    twin of the reference's ``xla_chunk``) at chunk 4 and 16,384
    particles; balanced equals collective bit for bit, an epoch resampled,
    and the evidence is within 0.2 of the Kalman filter's."""
    lz_b, n_b = _same_on_all_ranks(engines, "own_balanced")
    lz_c, n_c = _same_on_all_ranks(engines, "own_collective")
    assert lz_b == lz_c and n_b == n_c
    for r in engines:
        np.testing.assert_array_equal(r["own_balanced_states"], r["own_collective_states"])
    assert n_b >= 1
    assert abs(lz_b - float(kalman_filter_1d(W.lg_chunk_observations())[2])) < 0.2


def test_csis_dro_step_over_mesh_equals_single_process(pair):
    """One step with ``dro_rho`` on pinned traces, 16 a rank over a world of
    2: the robust weights are formed over all 32 traces on both ranks, and
    the Adam step equals the single process's on the whole batch."""
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=8, device="cpu")
    values, obs = eng._gen(torch.Generator().manual_seed(5), 32)
    params, losses = eng._train(eng.init(0), 1e-3, iter([(values, obs)]), None, None, 1,
                                dro_rho=W.DRO_RHO)
    flat = np.concatenate([t.reshape(-1).numpy() for t in tree_leaves(params)])
    np.testing.assert_allclose(_same_on_all_ranks(pair, "dro_params"), flat, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_same_on_all_ranks(pair, "dro_loss"), losses.numpy(),
                               rtol=1e-6)
    # the robust loss is not the plain mean: the weights were not uniform
    _, plain = eng._train(eng.init(0), 1e-3, iter([(values, obs)]), None, None, 1)
    assert float(losses[0]) > float(plain[0])
    assert np.isfinite(_same_on_all_ranks(pair, "dro_compile_losses")).all()


def test_sub_mesh_runs_smc_on_its_ranks(pair):
    """``particle_mesh(devices=[0])`` in a world of 2: rank 0 runs
    ``smc_sharded`` alone on it, rank 1 takes no part (and raises if it
    tries); the one-rank sweep, the two-rank sweep and the single-device
    ``build_smc_run`` agree within 4 combined SE + 0.02 and with Kalman
    (the counterpart of the reference's one-device mesh beside its
    eight-device one)."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.models import linear_gaussian_ssm

    r0, r1 = pair
    assert bool(r0["in_sub"]) and not bool(r1["in_sub"])
    assert str(r1["sub_outside"]).startswith("ValueError"), str(r1["sub_outside"])
    assert int(r0["sub_sis_n"]) == 64
    for r in pair:
        assert str(r["bad_ranks"]).startswith("ValueError")
    ys = torch.as_tensor(W.lg_observations())
    run = build_smc_run(linear_gaussian_ssm, W.N_SMC)
    single = [float(run(s, ys).log_evidence) for s in range(W.SEEDS)]
    exact = _exact("lg")
    sub, full = _stats(r0["sub_lz"]), _stats(_same_on_all_ranks(pair, "full_lz"))
    one = _stats(single)
    for mean, se in (sub, full, one):
        assert abs(mean - exact) < 4 * se + 0.02, (mean, se, exact)
    assert abs(sub[0] - one[0]) < 4 * (sub[1] + one[1]) + 0.02
    assert abs(sub[0] - full[0]) < 4 * (sub[1] + full[1]) + 0.02


def test_csis_compile_and_infer_over_mesh(engines):
    """Held as the reference's ``test_csis_infer_sharded`` and
    ``test_csis_compile_data_parallel`` hold its own."""
    losses = _same_on_all_ranks(engines, "compile_losses")
    _same_on_all_ranks(engines, "compile_params")
    assert np.isfinite(losses).all() and losses[-10:].mean() < losses[0]
    mean, ess, _ = _same_on_all_ranks(engines, "infer")
    assert abs(mean - 2.32353) < 0.05
    assert ess > 16_000


@pytest.mark.parametrize("name", ["infer_kwargs", "compile_divide", "compile_dro"])
def test_csis_mesh_errors(engines, name):
    want = "TypeError" if name == "infer_kwargs" else "ValueError"
    for r in engines:
        assert str(r[f"err_{name}"]).startswith(want), str(r[f"err_{name}"])


def test_dryrun_multichip_on_four_cpu_ranks(engines):
    keys = list(engines[0]["dryrun_keys"])
    got = dict(zip(keys, _same_on_all_ranks(engines, "dryrun")))
    assert abs(got["collective"] - got["kalman"]) < got["tol_collective"]
    assert abs(got["sis_mu"] - got["sis_exact"]) < got["tol_sis"]
    assert np.isfinite(got["csis_loss"])


# --------------------------------------------------------------------------
# set-up and the no-card rule


def test_particle_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        particle_mesh(device="cpu")
    assert not is_multihost()
    assert virtual_devices(4) == "torchrun --standalone --nproc-per-node=4"
    from torch.distributed.tensor import Replicate, Shard

    assert particle_sharding(None) == (Shard(0),)
    assert replicated_sharding(None) == (Replicate(),)


def test_no_card_raises_without_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        particle_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_multihost("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sis_sharded(gaussian_unknown_mean, (3.0, 4.0), 64, 0)
