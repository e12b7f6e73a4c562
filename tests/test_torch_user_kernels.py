"""The port's user-physics kernels (``cpprob_tpu_torch.ops.user_chunk``:
K10 scalar, K11 vector) and the vector resample epoch, against the JAX
package.

On the CPU the kernel path runs its plain PyTorch version.  The Pallas
kernels run in interpret mode, which pins eps to 0; the plain version gets
eps = 0 through ``draws=``.  The 2-D linear-Gaussian model and its Kalman
oracle are the ones of ``tests/test_vector_ssm.py``, written here with the
port's batched hooks.  Statistical checks use the 4·SE + 0.02 rule.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference import resampling as ref_rs
from cpprob_tpu.models.linear_gaussian import linear_gaussian_ssm as ref_lg_ssm
from cpprob_tpu.ops.pallas_ssm import (
    attach_fused_scalar_kernels as ref_attach_scalar,
)
from cpprob_tpu.ops.pallas_ssm import (
    attach_fused_vector_kernels as ref_attach_vector,
)
from cpprob_tpu_torch import StateSpaceModel, build_smc_run
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.models.linear_gaussian import (
    kalman_filter_1d,
    linear_gaussian_ssm,
    simulate_observations,
)
from cpprob_tpu_torch.ops import _build, elem, user_chunk
from cpprob_tpu_torch.ops.fused_ssm import (
    attach_fused_scalar_kernels,
    attach_fused_vector_kernels,
)
from cpprob_tpu_torch.ops.fused_lg import lg_chunk_plain
from cpprob_tpu_torch.ops.user_chunk import UserKernel, user_chunk_plain
from tests.test_vector_ssm import A, H, HALF_LOG_2PI, kalman_2d_loglik, make_lg2d

torch.set_num_threads(2)

N = 1 << 14
SEEDS = 8
FLOOR = 0.02
half_log_2pi = 0.9189385332046727
LOG_SD = math.log(0.6)


def lg_step_elem(x, y, eps):
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - half_log_2pi


def growth_step_elem(x, y, eps):
    """A non-linear physics: bounded growth, a tanh observation."""
    nx = 0.7 * x + 2.0 * elem.sin(x) + 0.5 * eps
    h = elem.tanh(nx)
    d = (y - elem.minimum(h, 2.0)) / 0.6
    return nx, -0.5 * d * d - LOG_SD - half_log_2pi


def growth_step_jax(x, y, eps):
    nx = 0.7 * x + 2.0 * jnp.sin(x) + 0.5 * eps
    d = (y - jnp.tanh(nx)) / 0.6
    return nx, -0.5 * d * d - jnp.log(0.6) - half_log_2pi


def lg2d_step_elem(x0, x1, y, e0, e1):
    n0 = 0.9 * x0 + 0.1 * x1 + e0
    n1 = 0.8 * x1 + e1
    d = y - (n0 + n1)
    return n0, n1, -0.5 * d * d - HALF_LOG_2PI


def lg2d_step_jax(xs, y, eps):
    x0, x1 = xs
    n0 = 0.9 * x0 + 0.1 * x1 + eps[0]
    n1 = 0.8 * x1 + eps[1]
    d = y - (n0 + n1)
    return [n0, n1], -0.5 * d * d - HALF_LOG_2PI


def _randn(key, shape):
    return torch.randn(shape, generator=key, device=key.device)


_A_T = torch.as_tensor(A.T, dtype=torch.float32)
_H_T = torch.as_tensor(H, dtype=torch.float32)


def _lg2d_obs_logpdf(s, y, t):
    d = y - s @ _H_T.to(s.device)
    return -0.5 * d * d - HALF_LOG_2PI


# the 2-D model of tests/test_vector_ssm.py with batched hooks
LG2D = StateSpaceModel(
    init_sample=lambda key: _randn(key, (2,)),
    init_logpdf=lambda s: torch.sum(-0.5 * s * s - HALF_LOG_2PI),
    step_sample=lambda key, s, t: s @ _A_T.to(s.device) + _randn(key, (2,)),
    step_logpdf=lambda ns, s, t: torch.sum(
        -0.5 * (ns - s @ _A_T.to(s.device)) ** 2 - HALF_LOG_2PI),
    obs_logpdf=_lg2d_obs_logpdf,
    init_sample_batch=lambda key, n: _randn(key, (n, 2)),
    step_sample_batch=lambda key, s, t: s @ _A_T.to(s.device) + _randn(key, s.shape),
    obs_logpdf_batch=_lg2d_obs_logpdf,
    vector_state_dim=2,
)


def _lg2d_observations(T=16, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2)
    ys = []
    for t in range(T):
        if t > 0:
            x = A @ x + rng.standard_normal(2)
        ys.append(H @ x + rng.standard_normal())
    return np.array(ys, np.float32)


def _mean_se(vals):
    vals = np.asarray(vals, np.float64)
    return vals.mean(), vals.std(ddof=1) / math.sqrt(len(vals))


@pytest.mark.parametrize("physics", ["lg", "growth"])
@pytest.mark.parametrize("n_valid", [3, 2])
def test_scalar_kernel_matches_pallas_interpret(physics, n_valid):
    port_fn, ref_fn = ((lg_step_elem, lg_step_elem) if physics == "lg"
                       else (growth_step_elem, growth_step_jax))
    rng = np.random.RandomState(3 + n_valid)
    n = 8 * 128
    x = rng.normal(size=n).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    ys = rng.normal(size=3).astype(np.float32)
    ref = ref_attach_scalar(ref_lg_ssm, ref_fn, block_r=8, interpret=True)
    s_j, w_j, ess_j = ref.fused_chunk_batch(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(w), jnp.asarray(ys),
        jnp.int32(n_valid))
    s, lw, rec = user_chunk_plain(
        port_fn, 1, 0, torch.as_tensor(x), torch.as_tensor(w),
        torch.as_tensor(ys), torch.tensor(n_valid, dtype=torch.int32),
        draws=torch.zeros(3, 1, 1))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lw.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5)
    from cpprob_tpu_torch.ops.fused_hmm import stats_from_partials

    np.testing.assert_allclose(float(stats_from_partials(rec, n)[0]),
                               float(ess_j), rtol=1e-5)


def test_vector_kernel_matches_pallas_interpret():
    rng = np.random.RandomState(11)
    n = 8 * 128
    x = rng.normal(size=(n, 2)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    ys = rng.normal(size=4).astype(np.float32)
    ref = ref_attach_vector(make_lg2d(), lg2d_step_jax, 2, block_r=8,
                            interpret=True)
    s_j, w_j, ess_j = ref.fused_chunk_batch(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(w), jnp.asarray(ys),
        jnp.int32(3))
    s, lw, rec = user_chunk_plain(
        lg2d_step_elem, 2, 0, torch.as_tensor(x), torch.as_tensor(w),
        torch.as_tensor(ys), torch.tensor(3, dtype=torch.int32),
        draws=torch.zeros(4, 2, 1))
    assert s.shape == (n, 2)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lw.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t0", [1, 2])
def test_scalar_kernel_draws_are_the_lg_kernels(t0):
    """With the LG physics, K10's plain version on Philox draws is K7's,
    bit for bit (same counters, same rounding), and its draws do not
    depend on the chunking."""
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.normal(size=8192).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=8192).astype(np.float32))
    ys = torch.as_tensor(rng.normal(size=8).astype(np.float32))
    a = user_chunk_plain(lg_step_elem, 1, 9, x, w, ys, t0=t0)
    b = lg_chunk_plain(9, x, w, ys, t0=t0)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    s, lw, _ = user_chunk_plain(lg_step_elem, 1, 9, x, w, ys[:3], t0=t0)
    s, lw, _ = user_chunk_plain(lg_step_elem, 1, 9, s, lw, ys[3:], t0=t0 + 3)
    assert torch.equal(s, a[0]) and torch.equal(lw, a[1])


def test_vector_draws_are_independent_planes():
    n = 1 << 15
    x = torch.zeros(n, 2)
    s, _, _ = user_chunk_plain(lg2d_step_elem, 2, 5, x, torch.zeros(n),
                               torch.zeros(1), t0=4)
    eps = s.numpy().astype(np.float64)          # one step from 0: x' = eps
    assert np.all(np.abs(eps.mean(0)) < 4 / math.sqrt(n))
    np.testing.assert_allclose(eps.var(0), [1.0, 1.0], atol=0.03)
    assert abs(np.corrcoef(eps.T)[0, 1]) < 4 / math.sqrt(n)


def test_step_elem_contract():
    """The physics is rendered into the generated CUDA source (a device
    function with one output reference a returned value, its elem calls as
    CUDA's precise functions, captured numbers as float32 literals, the
    planes read and written through the template's adaptor); a function
    outside the contract raises when the kernel object is built."""
    k = UserKernel(growth_step_elem, 1)
    src = k.source()
    assert ("__device__ __forceinline__ void step_elem(float v_x, float v_y, "
            "float v_eps, float& o_0, float& o_1)") in src
    assert "sinf(v_x)" in src and "tanhf(v_nx)" in src and "fminf(v_h, 2.0f)" in src
    assert f"{float(np.float32(half_log_2pi))!r}f" in src
    assert "constexpr int kD = 1;" in src and '#include "user_chunk.cuh"' in src
    k2 = UserKernel(lg2d_step_elem, 2)
    assert ("step_elem(x[0], x[1], y, eps[0], eps[1], nx[0], nx[1], log_emission);"
            in k2.source())
    assert "constexpr int kD = 2;" in k2.source()
    with pytest.raises(ValueError, match="lambda"):
        UserKernel(lambda x, y, e: (x, x), 1)
    table = torch.ones(3)

    def captures_tensor(x, y, eps):
        return x + table[0], x

    with pytest.raises(ValueError, match="Tensor"):
        UserKernel(captures_tensor, 1)

    def calls_torch(x, y, eps):
        return torch.exp(x), x

    with pytest.raises(ValueError, match="outside the contract"):
        UserKernel(calls_torch, 1)
    with pytest.raises(ValueError, match="positional"):
        UserKernel(lg_step_elem, 2)
    with pytest.raises(ValueError):
        attach_fused_scalar_kernels(linear_gaussian_ssm, calls_torch)
    # the elem namespace on tensors: numbers broadcast as fills
    t = torch.tensor([-1.0, 2.0])
    assert torch.equal(elem.maximum(t, 0.0), torch.tensor([0.0, 2.0]))
    assert torch.equal(elem.where(t > 0, t, 5.0), torch.tensor([5.0, 2.0]))


def test_morton_key_matches_reference():
    rng = np.random.default_rng(5)
    for d in (1, 2, 3):
        states = rng.standard_normal((1 << 13, d)).astype(np.float32)
        states[:50] = states[50:100]              # ties: ranks are stable
        got = rs.morton_key(torch.as_tensor(states)).numpy()
        want = np.asarray(ref_rs.morton_key(jnp.asarray(states))).astype(np.int64)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        rs.morton_key(torch.zeros(4, 4))


@pytest.mark.parametrize("sort_key", [None, rs.morton_key])
def test_vector_resample_in_distribution(sort_key):
    rng = np.random.default_rng(1)
    n = 1 << 14
    states = torch.as_tensor(rng.standard_normal((n, 2)).astype(np.float32))
    log_w = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    w = torch.softmax(log_w.double(), 0).numpy()
    target = (w[:, None] * states.numpy()).sum(0)
    outs = [rs.sorted_systematic_resample_values_nd(
        torch.Generator().manual_seed(i), log_w, states, sort_key)
        for i in range(8)]
    src = {tuple(r) for r in states.numpy().tolist()}
    assert all(tuple(r) in src for r in outs[0].numpy().tolist()[:500])
    np.testing.assert_allclose(np.mean([o.numpy().mean(0) for o in outs], 0),
                               target, atol=0.02)
    # the reference, on the same population, in distribution
    ref_means = np.mean([np.asarray(ref_rs.sorted_systematic_resample_values_nd(
        jax.random.key(i), jnp.asarray(log_w.numpy()), jnp.asarray(states.numpy()),
        None if sort_key is None else ref_rs.morton_key)).mean(0)
        for i in range(8)], 0)
    np.testing.assert_allclose(np.mean([o.numpy().mean(0) for o in outs], 0),
                               ref_means, atol=0.03)
    # a dominant particle floods the output
    lw = torch.full((1024,), -100.0)
    lw[137] = 10.0
    st = torch.arange(2048, dtype=torch.float32).reshape(1024, 2)
    out = rs.sorted_systematic_resample_values_nd(torch.Generator().manual_seed(0),
                                                  lw, st, sort_key)
    assert torch.equal(out, st[137].expand(1024, 2))


def test_vector_epoch_follows_the_flag():
    rng = np.random.default_rng(2)
    states = torch.as_tensor(rng.standard_normal((4096, 2)).astype(np.float32))
    log_w = torch.as_tensor(rng.standard_normal(4096).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    off = torch.zeros((), dtype=torch.int32)
    new, lme = rs.continuous_resample_values_lme(gen, log_w, states, flag=off)
    assert torch.equal(new, states)
    np.testing.assert_allclose(float(lme), float(torch.logsumexp(
        log_w.double(), 0) - math.log(4096)), rtol=1e-12)
    new = rs.continuous_resample_values(gen, log_w, states,
                                        flag=torch.ones((), dtype=torch.int32))
    assert new.shape == states.shape and not torch.equal(new, states)


@pytest.mark.parametrize("chunk", [8, 1])
def test_scalar_path_matches_kalman(chunk):
    """Path 5 (chunk 8: K10 and the streaming epoch) and the one-step
    launches (chunk 1), through the plain versions."""
    obs = simulate_observations(16, 0)
    run = build_smc_run(attach_fused_scalar_kernels(linear_gaussian_ssm,
                                                    lg_step_elem), N, chunk=chunk)
    results = [run(i, torch.as_tensor(obs)) for i in range(SEEDS)]
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    exact = kalman_filter_1d(obs)[2]
    assert abs(exact - (-32.408189)) < 1e-5
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)
    assert all(bool(r.resampled.any()) for r in results)


@pytest.mark.parametrize("chunk", [4, 1])
def test_vector_path_matches_kalman(chunk):
    """Path 6 (chunk 4: K11 and the vector epoch) and the unfused per-step
    vector path (chunk 1), through the plain versions."""
    ys = _lg2d_observations()
    model = (attach_fused_vector_kernels(LG2D, lg2d_step_elem, 2) if chunk > 1
             else LG2D)
    run = build_smc_run(model, N, chunk=chunk)
    results = [run(i, torch.as_tensor(ys)) for i in range(SEEDS)]
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    exact = kalman_2d_loglik(ys)
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)
    for r in results:
        assert r.final_states.shape == (N, 2)
        assert bool(r.resampled.any())


@pytest.mark.cuda
def test_user_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    errs, _ = chip_smoke.check_user_kernels(1 << 16)
    assert errs["scalar"] < 1e-3 and errs["vector"] < 1e-3


def test_no_library_is_built_or_loaded_on_the_cpu_path():
    k = UserKernel(lg_step_elem, 1)
    before = dict(_build._LIBS)
    k.chunk(0, torch.zeros(4096), torch.zeros(4096), torch.zeros(2))
    assert _build._LIBS == before and k.library is None
    assert user_chunk.LAUNCHES["scalar"] == 0 and "triton" not in sys.modules
