"""The port's guided kernels against the JAX package: K12, the guided
scalar chunk kernel (``cpprob_tpu_torch.ops.guided_scalar``), and K13, the
guided discrete chunk kernel (``cpprob_tpu_torch.ops.fused_hmm``), with
the MLP of ``cpprob_tpu_torch.inference.nn`` they evaluate.

On the CPU the kernel wrappers run their plain PyTorch versions.  The
Pallas kernels run in interpret mode, which pins the draws: eps = 0 for
K12, u = 0 and the island offset u0 = 0.5 for K13; the plain versions get
the same draws through ``draws=``.  Both packages get the same nets (numpy
arrays, converted by ``interop.mlp_params_from_numpy``).

The one q (F1): the port's proposal scale is ``softplus(raw) + 1e-6``
everywhere, the reference's fused kernels use a plain softplus, so log q
differs by about 1e-6/std per step; the nets here keep std near 1, and
the log-weight tolerances below allow that gap.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference import nn as ref_nn
from cpprob_tpu.models.linear_gaussian import linear_gaussian_ssm as ref_lg
from cpprob_tpu.ops.pallas_ssm import (
    attach_fused_guided_discrete_kernels as ref_attach_discrete,
)
from cpprob_tpu.ops.pallas_ssm import (
    attach_fused_guided_scalar_kernels as ref_attach_scalar,
)
from cpprob_tpu_torch.inference import nn
from cpprob_tpu_torch.interop import mlp_params_from_numpy, spec_from_numpy
from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm
from cpprob_tpu_torch.ops import elem, fused_hmm
from cpprob_tpu_torch.ops.fused_hmm import (
    GuidedTables,
    guided_chunk,
    guided_chunk_plain,
    guided_tables_plain,
    stats_from_partials,
)
from cpprob_tpu_torch.ops.fused_ssm import (
    attach_fused_guided_discrete_kernels,
    attach_fused_guided_scalar_kernels,
)
from cpprob_tpu_torch.ops.guided_scalar import (
    GUIDED_BLOCK,
    GuidedScalarKernel,
    _net_plain,
    guided_scalar_chunk_plain,
)
from cpprob_tpu_torch.ops.guided_tc import GuidedTensorCoreKernel
from test_torch_fused_hmm import CHECKS, _one_step_launches, pinned_step_draws

torch.set_num_threads(2)

half_log_2pi = 0.9189385332046727
TRANS5 = np.array([[0.50, 0.20, 0.10, 0.10, 0.10],
                   [0.05, 0.60, 0.20, 0.10, 0.05],
                   [0.10, 0.10, 0.40, 0.30, 0.10],
                   [0.20, 0.05, 0.05, 0.50, 0.20],
                   [0.10, 0.10, 0.10, 0.10, 0.60]])
MEANS5 = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
STDS5 = np.array([0.5, 1.0, 0.7, 1.2, 0.9])
INIT5 = np.array([0.3, 0.1, 0.2, 0.2, 0.2])
N = 8 * 128          # one (8, 128) tile of the Pallas kernels
T = 8


def trans_lp(x, nx, t):
    d = nx - x
    return -0.5 * d * d - half_log_2pi


def obs_lp(nx, y, t):
    d = y - nx
    return -0.5 * d * d - half_log_2pi


def _net(sizes, seed, raw_bias=0.5, scale=0.4):
    """A numpy net with non-zero biases; the last bias of a 'normal' head
    keeps softplus(raw) near 1."""
    rng = np.random.default_rng(seed)
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers.append({"w": (scale * rng.standard_normal((a, b))).astype(np.float32),
                       "b": (0.1 * rng.standard_normal(b)).astype(np.float32)})
    if sizes[-1] == 2:
        layers[-1]["b"][1] += raw_bias
    return layers


# --------------------------------------------------------------------------
# the MLP


def test_mlp_apply_matches_reference():
    params = _net([7, 8, 8, 5], 0)
    x = np.random.default_rng(1).standard_normal((64, 7)).astype(np.float32)
    want = np.asarray(ref_nn.mlp_apply(params, jnp.asarray(x)))
    got = nn.mlp_apply(mlp_params_from_numpy(params, device="cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_softplus_matches_reference():
    x = np.linspace(-120.0, 120.0, 4001, dtype=np.float32)
    want = np.asarray(ref_nn.softplus(jnp.asarray(x)))
    got = nn.softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.min() >= 1e-6


def test_mlp_init_layout_and_scale():
    gen = torch.Generator()
    gen.manual_seed(0)
    params = nn.mlp_init([3, 64, 64, 2], gen)
    assert [tuple(p["w"].shape) for p in params] == [(3, 64), (64, 64), (64, 2)]
    assert all(float(p["b"].abs().max()) == 0.0 for p in params)
    # Kaiming normal: std sqrt(2 / fan_in)
    assert abs(float(params[1]["w"].std()) - math.sqrt(2 / 64)) < 0.02
    params[0]["w"].requires_grad_()
    nn.mlp_apply(params, torch.ones(4, 3)).sum().backward()
    assert params[0]["w"].grad is not None


# --------------------------------------------------------------------------
# K12


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("t0,n_valid", [(3, 2), (1, 3), (6, 1)])
def test_guided_scalar_matches_pallas_interpret(mxu, t0, n_valid):
    params = _net([3, 8, 8, 2], 2)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(N).astype(np.float32)
    w0 = (0.3 * rng.standard_normal(N)).astype(np.float32)
    ys = np.array([0.5, -0.25, 1.1], np.float32)
    ref = ref_attach_scalar(ref_lg, params, T, trans_logpdf_elem=trans_lp,
                            obs_logpdf_elem=obs_lp, block_r=8,
                            interpret=True, mxu=mxu)
    s_r, w_r, ess_r = ref.fused_chunk_t_batch(
        jax.random.key(0), jnp.asarray(x0), jnp.asarray(w0), jnp.asarray(ys),
        jnp.int32(n_valid), jnp.int32(t0))
    # the port's model with the same mxu: the twin's kernel object, run on
    # CPU tensors (its plain version) with the reference's pinned eps = 0
    model = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, mlp_params_from_numpy(params, device="cpu"), T,
        trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp, mxu=mxu)
    kernel = model.fused_chunk_t_batch.kernel
    assert isinstance(kernel, GuidedTensorCoreKernel if mxu else GuidedScalarKernel)
    s, w, rec = kernel.chunk(
        0, torch.as_tensor(x0), torch.as_tensor(w0), torch.as_tensor(ys),
        torch.tensor(n_valid, dtype=torch.int32), t0=t0,
        draws=torch.zeros(len(ys), 1))
    # states: float32 rounding of the net (the MXU twin sums its dots in
    # another order)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-5)
    # log_w: that, and the F1 gap of ~1e-6/std per step (std ~ 1 here)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-5, atol=3e-5)
    ess = float(stats_from_partials(rec, N)[0])
    assert abs(ess - float(ess_r)) < 1e-3 * N


def test_guided_scalar_serves_the_fallbacks_q():
    """F1: the kernel's plain version scores its move with the q that the
    fallback ``proposal_logpdf`` serves (scale softplus(raw) + 1e-6); the
    net's scale is ~3e-4 here, where dropping the 1e-6 would move log q by
    ~3e-3."""
    params = _net([3, 8, 8, 2], 12, raw_bias=-8.0, scale=0.05)
    model = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, mlp_params_from_numpy(params, device="cpu"), T,
        trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    x0 = torch.linspace(-1.5, 1.5, 512)
    y = torch.tensor([0.4])
    nx, w, _ = guided_scalar_chunk_plain(
        mlp_params_from_numpy(params, device="cpu"), trans_lp, obs_lp, T, 0, x0,
        torch.zeros(512), y, t0=3, draws=torch.full((1, 1), 0.5))
    want = (trans_lp(x0, nx, 3) + obs_lp(nx, y[0], 3)
            - model.proposal_logpdf(nx, x0, 3, y[0]))
    np.testing.assert_allclose(w.numpy(), want.numpy(), rtol=0, atol=2e-4)


def test_guided_scalar_draws_and_kernel_wrapper():
    """The wrapper takes the plain version on CPU tensors; with eps from
    Philox it moves the particles, and n_valid masks the tail."""
    params = mlp_params_from_numpy(_net([3, 8, 8, 2], 4), device="cpu")
    k = GuidedScalarKernel(params, trans_lp, obs_lp, T)
    assert k.layer_sizes() == [3, 8, 8, 2]
    x0 = torch.linspace(-2, 2, 4096)
    w0 = torch.zeros(4096)
    ys = torch.tensor([0.3, -0.2, 0.9])
    s2, w2, rec = k.chunk(7, x0, w0, ys, torch.tensor(2, dtype=torch.int32), t0=4)
    s3, w3, _ = k.chunk(7, x0, w0, ys[:2], t0=4)
    assert torch.equal(s2, s3) and torch.equal(w2, w3)
    assert rec.shape == (4096 // GUIDED_BLOCK, 3)
    zero = guided_scalar_chunk_plain(params, trans_lp, obs_lp, T, 7, x0, w0,
                                     ys, t0=4, draws=torch.zeros(3, 1))
    assert not torch.equal(zero[0], k.chunk(7, x0, w0, ys, t0=4)[0])


_PRELUDE = """
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
static inline float __frcp_rn(float a) { return 1.0f / a; }
static inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
"""


@pytest.mark.parametrize("sizes,per", [([3, 2], 4), ([3, 8, 8, 2], 4), ([3, 16, 16, 2], 4),
                                       ([3, 32, 32, 2], 2), ([3, 64, 64, 2], 1),
                                       ([3, 300, 2], 1)])
def test_guided_scalar_particles_a_thread_follow_the_width(sizes, per):
    """K12 holds four particles a thread up to hidden layers of 16 units and
    fewer above, so a thread keeps at most 64 activations; the generated
    source and the wrapper's block agree."""
    from cpprob_tpu_torch.ops.guided_scalar import per_thread

    k = GuidedScalarKernel(_net(sizes, 1), trans_lp, obs_lp, T)
    assert per_thread(sizes) == per and k.block() == 256 * per
    assert f"constexpr int kPerThread = {per};" in k.source()


def test_guided_scalar_source_renders_the_net(tmp_path):
    """The generated CUDA source bakes every weight and bias in as a float32
    literal that converts back exactly, carries each density under its own
    name, and includes the kernel's header.  Its model part (the net and
    the densities) compiles on the host, where ``fmaf`` rounds each
    multiply-add once as the card's ``__fmaf_rn`` does: the net there gives
    ``_net_plain``'s (mean, raw) bit for bit."""
    import ctypes
    import re
    import shutil
    import subprocess

    sizes = [3, 4, 5, 2]
    params = _net(sizes, 5)
    src = GuidedScalarKernel(params, trans_lp, obs_lp, 16).source()
    literals = {np.float32(v) for v in re.findall(r"(-?\d+\.\d+(?:e-?\d+)?)f\b", src)}
    for layer in params:
        for v in np.concatenate([layer["w"].ravel(), layer["b"]]):
            assert np.float32(float(repr(float(v)))) == v
            assert v in literals, v
    assert "float trans_logpdf_elem(float v_x, float v_nx, float v_t)" in src
    assert "float obs_logpdf_elem(float v_nx, float v_y, float v_t)" in src
    assert src.count("__fmaf_rn(") == 4 + 4 * 5 + 2 * 5
    assert src.rstrip().endswith('#include "guided_scalar.cuh"')
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    model = src.split('#include "guided_scalar.cuh"')[0]
    (tmp_path / "k.cpp").write_text(
        _PRELUDE + model + 'extern "C" void run(const float* x, float y, float tf, '
        "float* mean, float* raw, int n) {\n"
        "  using namespace guided_scalar_model;\n  float c[kFirst];\n"
        "  first_consts(y, tf, c);\n"
        "  for (int i = 0; i < n; ++i) net(x[i], c, mean[i], raw[i]);\n}\n")
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", str(tmp_path / "k.so"),
                    str(tmp_path / "k.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "k.so"))
    n = 4096
    x = np.random.default_rng(1).normal(0, 2, n).astype(np.float32)
    mean, raw = np.empty(n, np.float32), np.empty(n, np.float32)
    p = ctypes.POINTER(ctypes.c_float)
    y, tf = np.float32(0.7), np.float32(3.0) / np.float32(16.0)
    lib.run(x.ctypes.data_as(p), ctypes.c_float(y), ctypes.c_float(tf),
            mean.ctypes.data_as(p), raw.ctypes.data_as(p), ctypes.c_int(n))
    net = ([torch.as_tensor(lay["w"]) for lay in params],
           [torch.as_tensor(lay["b"]) for lay in params])
    want = _net_plain(net, torch.as_tensor(x), torch.tensor(y), torch.tensor(tf))
    np.testing.assert_array_equal(mean, want[0].numpy())
    np.testing.assert_array_equal(raw, want[1].numpy())


def _round32(fr):
    """A rational number correctly rounded to float32 (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(fr))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(np.array(c).view(np.int32)) & 1))


def test_net_plain_rounds_each_multiply_add_once():
    """``_net_plain`` takes the kernel's order with each multiply-add
    rounded once: bit-equal to the same chain taken in exact rational
    arithmetic and correctly rounded to float32 after each multiply-add,
    and within float32-level rounding of the net in float64.  One fused
    multiply-add where rounding the product first loses the answer."""
    from fractions import Fraction

    from cpprob_tpu_torch.ops.guided_scalar import _fma

    a = torch.tensor([1 + 2.0 ** -13])
    c = torch.tensor([-(1 + 2.0 ** -12)])
    assert float(a * a + c) == 0.0 and float(_fma(a, a, c)) == 2.0 ** -26

    sizes = [3, 4, 5, 2]
    layers = _net(sizes, 11)
    Ws = [lay["w"] for lay in layers]
    bs = [lay["b"] for lay in layers]
    x = np.random.default_rng(12).normal(0, 2, 64).astype(np.float32)
    y, tf = np.float32(-0.4), np.float32(5.0) / np.float32(16.0)
    got = _net_plain(([torch.as_tensor(W) for W in Ws], [torch.as_tensor(b) for b in bs]),
                     torch.as_tensor(x), torch.tensor(y), torch.tensor(tf))
    F = lambda v: Fraction(float(v))  # noqa: E731
    c = (Ws[0][1] * y + Ws[0][2] * tf) + bs[0]          # float32, as the kernel
    for i in range(64):
        act = [_round32(F(x[i]) * F(Ws[0][0, j]) + F(c[j])) for j in range(sizes[1])]
        for W, b in zip(Ws[1:], bs[1:]):
            act = [max(v, np.float32(0)) for v in act]
            out = []
            for j in range(W.shape[1]):
                acc = b[j]
                for k, v in enumerate(act):
                    acc = _round32(F(v) * F(W[k, j]) + F(acc))
                out.append(acc)
            act = out
        assert (got[0][i].item(), got[1][i].item()) == (float(act[0]), float(act[1])), i
    # float64 throughout
    h = np.maximum(x[:, None].astype(np.float64) * Ws[0][0] + (Ws[0][1].astype(np.float64) * y
                   + Ws[0][2] * np.float64(tf) + bs[0]), 0)
    h = np.maximum(h @ Ws[1] + bs[1], 0)
    ref = h @ Ws[2] + bs[2]
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# K13


def _discrete_ref(params, mxu, **kw):
    return ref_attach_discrete(TRANS5, MEANS5, STDS5, INIT5, params=params,
                               T=T, block_r=8, interpret=True, mxu=mxu, **kw)


def _discrete_port(params, K=5, trans=TRANS5, means=MEANS5, stds=STDS5,
                   init=INIT5):
    spec = spec_from_numpy(trans, means, stds, init)
    gt = GuidedTables.from_params(np.log(np.maximum(trans, 1e-38)),
                                  mlp_params_from_numpy(params, device="cpu"), T)
    return spec, gt


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("flag,n_valid,t0", [(0, 3, 1), (1, 2, 5), (1, 0, 2)])
def test_guided_discrete_matches_pallas_interpret(mxu, flag, n_valid, t0):
    K = 5
    params = _net([K + 2, 8, 8, K], 6, scale=0.6)
    rng = np.random.default_rng(7)
    states = rng.integers(0, K, N).astype(np.int32)
    w0 = (0.3 * rng.standard_normal(N)).astype(np.float32)
    ys = np.array([0.5, -1.5, 2.2], np.float32)
    ticks = np.array([100, 300, 600, 900], np.int32)
    s_r, w_r, ess_r, cat_r, lme_r = _discrete_ref(params, mxu).fused_chunk_exchange_t_batch(
        jax.random.key(0), jnp.asarray(states), jnp.asarray(w0), jnp.asarray(ys),
        jnp.int32(n_valid), jnp.int32(flag), jnp.asarray(ticks), jnp.int32(t0))
    spec, gt = _discrete_port(params)
    ctrl = torch.tensor([flag, *ticks, n_valid], dtype=torch.int32)
    s, w, rec = guided_chunk_plain(
        0, torch.as_tensor(states), torch.as_tensor(w0), torch.as_tensor(ys),
        ctrl, spec, gt, t0=t0, island_size=N,
        draws=(torch.zeros(len(ys), N), torch.zeros(0, 1)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    # log_w: the RN sum is grouped as log p + (log g - log q) against the
    # reference's per-twin order, the emission from float32 tables: float32
    # rounding of terms of magnitude ~10
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-5, atol=2e-5)
    ess, cat_w, lme = (x.numpy() for x in stats_from_partials(rec, N))
    np.testing.assert_allclose(cat_w, np.asarray(cat_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ess, float(ess_r), rtol=1e-4)
    np.testing.assert_allclose(lme, float(lme_r), rtol=0, atol=1e-4)


@pytest.mark.parametrize("sizes,mxu", [
    ([7, 128, 128, 128, 5], True), ([7, 256, 5], False),
    ([7] + [16] * 9 + [5], True), ([7] + [16] * 9 + [5], False)],
    ids=["wide-mxu", "wide-vpu", "deep-mxu", "deep-vpu"])
def test_guided_discrete_wide_and_deep_nets_match_pallas_interpret(sizes, mxu):
    """Nets past the old 64-unit, 8-layer limits (a [7, 128, 128, 128, 5]
    net and ten layers of 16) through the plain version against both JAX
    twins, as the narrow net above.  The reference's per-unit twin unrolls
    every weight into its trace, so it gets one step, and its wide net one
    hidden layer of 256 (128 x 128 layers take minutes to trace there)."""
    K = 5
    params = _net(sizes, 21, scale=1.0 / np.sqrt(sizes[1]))
    rng = np.random.default_rng(22)
    states = rng.integers(0, K, N).astype(np.int32)
    w0 = (0.3 * rng.standard_normal(N)).astype(np.float32)
    ys = np.array([0.5, -1.5][:2 if mxu else 1], np.float32)
    nv = len(ys)
    ticks = np.array([100, 300, 600, 900], np.int32)
    s_r, w_r, ess_r, cat_r, lme_r = _discrete_ref(params, mxu).fused_chunk_exchange_t_batch(
        jax.random.key(0), jnp.asarray(states), jnp.asarray(w0), jnp.asarray(ys),
        jnp.int32(nv), jnp.int32(1), jnp.asarray(ticks), jnp.int32(3))
    spec, gt = _discrete_port(params)
    assert gt.dims == sizes
    s, w, rec = guided_chunk_plain(
        0, torch.as_tensor(states), torch.as_tensor(w0), torch.as_tensor(ys),
        torch.tensor([1, *ticks, nv], dtype=torch.int32), spec, gt, t0=3,
        island_size=N, draws=(torch.zeros(len(ys), N), torch.zeros(0, 1)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    # float32 sums over 128 inputs in another order (the MXU twin's dots)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-5, atol=5e-5)
    ess, cat_w, lme = (x.numpy() for x in stats_from_partials(rec, N))
    np.testing.assert_allclose(cat_w, np.asarray(cat_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ess, float(ess_r), rtol=1e-4)
    np.testing.assert_allclose(lme, float(lme_r), rtol=0, atol=1e-4)


@pytest.mark.parametrize("checks", ["none", "silent", "firing"])
@pytest.mark.parametrize("t0", [4, 5, 6, 7])
def test_guided_chunk_equals_its_steps_one_at_a_time(t0, checks):
    """K13's plain version at K = 5 under K8's draws (word t & 3 of (g,
    t >> 2, 2, 0)): a chunk from t0 = 0, 1, 2, 3 (mod 4) with n_valid 6 of 8
    against its steps launched one at a time, bit for bit, without island
    checks and with a check every 3 steps that never fires; with one that
    fires, against the chunk on the per-step draws pinned through
    ``draws=`` (as ``test_chunk_equals_its_steps_one_at_a_time`` of the
    unguided chain)."""
    K, n, steps, n_valid, seed = 5, 2 * fused_hmm.ISLAND_SIZE, 8, 6, 91
    spec, gt = _discrete_port(_net([K + 2, 8, 8, K], 6, scale=0.6))
    rng = np.random.default_rng(t0)
    s0 = torch.as_tensor(rng.integers(0, K, n).astype(np.int32))
    w0 = torch.as_tensor((0.3 * rng.standard_normal(n)).astype(np.float32))
    ys = torch.as_tensor(rng.standard_normal(steps).astype(np.float32))
    ctrl = torch.tensor([1, *[n * (k + 1) // K for k in range(K - 1)], n_valid],
                        dtype=torch.int32)
    every, thresh = CHECKS[checks]
    out = guided_chunk_plain(seed, s0, w0, ys, ctrl, spec, gt, t0=t0,
                             island_every=every, island_thresh=thresh)
    if checks == "firing":
        ref = guided_chunk_plain(seed, s0, w0, ys, ctrl, spec, gt, t0=t0,
                                 island_every=every, island_thresh=thresh,
                                 draws=pinned_step_draws(seed, n, t0, steps, every))
        assert float(out[2][:, -1].min()) == 1.0
    else:
        ref = _one_step_launches(
            lambda s, w, y, c, t: guided_chunk_plain(seed, s, w, y, c, spec, gt, t0=t),
            s0, w0, ys, ctrl, K, t0)
        assert float(out[2][:, -1].max()) == 0.0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mxu", [False, True])
def test_guided_one_state_chain_matches_reference(mxu):
    """K = 1: q = 1, the RN correction is 0, and the guided chunk is the
    unguided K = 1 chain: against the reference's K = 1 model in interpret
    mode (pinned draws), against the unguided plain chunk bit for bit, and
    the sweep's logZ against the forward recursion."""
    from cpprob_tpu_torch import build_smc_run
    from cpprob_tpu_torch.ops.fused_hmm import hmm_chunk_plain
    from cpprob_tpu_torch.ops.fused_ssm import discrete_hmm_log_evidence

    trans, means, stds, init = [[1.0]], [0.4], [0.8], [1.0]
    params = _net([3, 8, 8, 1], 23, scale=0.6)
    rng = np.random.default_rng(24)
    w0 = (0.3 * rng.standard_normal(N)).astype(np.float32)
    ys = np.array([0.5, -1.5, 2.2], np.float32)
    ref = ref_attach_discrete(trans, means, stds, init, params=params, T=T,
                              block_r=8, interpret=True, mxu=mxu)
    s_r, w_r, ess_r, _, lme_r = ref.fused_chunk_exchange_t_batch(
        jax.random.key(0), jnp.zeros(N, jnp.int32), jnp.asarray(w0),
        jnp.asarray(ys), jnp.int32(3), jnp.int32(0), jnp.zeros((0,), jnp.int32),
        jnp.int32(2))
    spec, gt = _discrete_port(params, 1, np.array(trans), means, stds, init)
    ctrl = torch.tensor([0, 3], dtype=torch.int32)
    draws = (torch.zeros(len(ys), N), torch.zeros(0, 1))
    args = (0, torch.zeros(N, dtype=torch.int32), torch.as_tensor(w0),
            torch.as_tensor(ys), ctrl, spec)
    s, w, rec = guided_chunk_plain(*args, gt, t0=2, island_size=N, draws=draws)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-5, atol=2e-5)
    ess, _, lme = stats_from_partials(rec, N)
    np.testing.assert_allclose(float(ess), float(ess_r), rtol=1e-4)
    np.testing.assert_allclose(float(lme), float(lme_r), rtol=0, atol=1e-4)
    s_u, w_u, rec_u = hmm_chunk_plain(*args, t0=2, island_size=N, draws=draws)
    assert torch.equal(s, s_u) and torch.equal(w, w_u) and torch.equal(rec, rec_u)
    # the wrapper on CPU tensors (Philox draws) equals the unguided chunk
    n = fused_hmm.ISLAND_SIZE
    got = guided_chunk(5, torch.zeros(n, dtype=torch.int32), torch.zeros(n),
                       torch.as_tensor(ys), ctrl, spec, gt, t0=2)
    want = fused_hmm.hmm_chunk(5, torch.zeros(n, dtype=torch.int32), torch.zeros(n),
                               torch.as_tensor(ys), ctrl, spec, t0=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # one state: every particle carries the same weight, logZ is exact
    model = attach_fused_guided_discrete_kernels(
        trans, means, stds, init, params=mlp_params_from_numpy(params, device="cpu"), T=T)
    obs = np.array([0.5, -1.5, 2.2, 0.1, 0.9, -0.3, 1.4], np.float32)
    exact = discrete_hmm_log_evidence(trans, means, stds, init, obs)
    for chunk in (4, 1):
        res = build_smc_run(model, n, chunk=chunk)(3, torch.as_tensor(obs))
        assert abs(float(res.log_evidence) - exact) < 1e-4, (chunk, exact)


def test_guided_discrete_one_step_matches_reference_math():
    """The per-step hook (K13 launched for one step) at u = 0 against the
    smc_csis arithmetic, as tests/test_pallas_ssm.py:418-446 checks the
    reference kernel."""
    K = 5
    params = _net([K + 2, 8, 8, K], 8)
    spec, gt = _discrete_port(params)
    y, t = 0.5, 2
    ctrl = torch.tensor([0, 0, 0, 0, 0, 1], dtype=torch.int32)
    s, w, rec = guided_chunk_plain(
        0, torch.full((N,), 3, dtype=torch.int32), torch.zeros(N),
        torch.tensor([y]), ctrl, spec, gt, t0=t, island_size=N,
        draws=(torch.zeros(1, N), None))
    feats = jnp.concatenate([jax.nn.one_hot(3, K), jnp.array([y]),
                             jnp.array([t / T])])
    log_q0 = float(jax.nn.log_softmax(ref_nn.mlp_apply(params, feats))[0])
    log_g = (-0.5 * ((y - MEANS5[0]) / STDS5[0]) ** 2 - np.log(STDS5[0])
             - half_log_2pi)
    expected = np.log(TRANS5[3, 0]) + log_g - log_q0
    assert bool((s == 0).all())
    np.testing.assert_allclose(w.numpy(), expected, rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(stats_from_partials(rec, N)[1].numpy(),
                               [1, 0, 0, 0, 0], atol=1e-6)


def test_guided_tables_follow_their_definition():
    """cum's last column is ssum, and rn is log p + log g - log q of the net
    (float64 numpy replay)."""
    K = 5
    params = _net([K + 2, 8, 8, K], 9)
    spec, gt = _discrete_port(params)
    y, tf = torch.tensor(0.7), torch.tensor(3 / T)
    cum, ssum, rn = guided_tables_plain(spec.tables("cpu"), gt.tables("cpu"), y, tf)
    assert torch.equal(cum[:, -1], ssum)
    feats = np.concatenate([np.eye(K), np.full((K, 1), 0.7), np.full((K, 1), 3 / T)], 1)
    h = feats
    for i, layer in enumerate(params):
        h = h @ layer["w"].astype(np.float64) + layer["b"]
        if i < len(params) - 1:
            h = np.maximum(h, 0)
    log_q = h - np.log(np.exp(h).sum(1, keepdims=True))
    log_g = -0.5 * ((0.7 - MEANS5) / STDS5) ** 2 - np.log(STDS5) - half_log_2pi
    want = np.log(TRANS5) + log_g[None, :] - log_q
    np.testing.assert_allclose(rn.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cum.numpy() / ssum.numpy()[:, None],
                               np.cumsum(np.exp(log_q), 1), atol=1e-6)


def _island_args():
    trans = np.array([[0.8, 0.2], [0.3, 0.7]])
    params = _net([4, 8, 8, 2], 10, scale=0.5)
    ys = np.linspace(-1, 1, 8).astype(np.float32)
    return trans, params, ys


def test_guided_tables_wrapper_stacks_the_plain_tables():
    """``guided_tables`` on CPU tensors: each step's row is cum | ssum | rn
    of ``guided_tables_plain`` at that step's observation and t/T, the rows
    the tables kernel writes on the card and the chunk kernel reads."""
    spec, gt = _discrete_port(_net([7, 8, 8, 5], 3))
    ys = torch.tensor([0.5, -1.25, 2.0, 0.0])
    ctrl = torch.tensor([0, 0, 0, 0, 0, 4], dtype=torch.int32)
    rows = fused_hmm.guided_tables(ys, ctrl, spec, gt, t0=7)
    assert rows.shape == (4, 2 * 25 + 5) and rows.dtype == torch.float32
    tab, gtab = spec.tables("cpu"), gt.tables("cpu")
    for t in range(4):
        tf = torch.tensor(float(7 + t), dtype=torch.float32) / float(T)
        cum, ssum, rn = guided_tables_plain(tab, gtab, ys[t], tf)
        assert torch.equal(rows[t], torch.cat([cum.reshape(-1), ssum, rn.reshape(-1)]))
    assert torch.equal(rows[:, 25:30], rows[:, 4:25:5])      # ssum = cum[:, K-1]


def test_guided_chain_parts_variants_find_their_lines():
    """``util/guided_chain_parts.py`` builds K13's designs by substituting
    lines of ``csrc/fused_hmm.cu``: each still finds its lines, only
    ``tables_kernel`` is the source as it is, and ``in_cta`` (every CTA
    building its tables) keeps no tables wait or copy in the chunk
    kernel."""
    from pathlib import Path

    from cpprob_tpu_torch.util import chain_parts, guided_chain_parts

    kept_text = (Path(fused_hmm.__file__).parent / "csrc" / "fused_hmm.cu").read_text()
    kept = chain_parts.variant_source([])
    for name, subs in guided_chain_parts.VARIANTS.items():
        text = chain_parts.variant_source(
            guided_chain_parts.in_cta_subs(kept_text) if subs is None else subs)
        assert (text == kept) == (name == "tables_kernel")
    in_cta = chain_parts.variant_source(guided_chain_parts.in_cta_subs(kept_text))
    assert "asm volatile(\"griddepcontrol.wait" not in in_cta
    assert "__ldcg(tabs" not in in_cta
    assert "guided_build<K>(net, nd, tab, ltab, ys + t, len" in in_cta
    assert in_cta.count("int guided_chunk_launch(") == 1


def test_guided_island_threshold_zero_is_no_island():
    """tests/test_pallas_ssm.py:593-611: threshold 0 equals no island, bit
    for bit; and the port's frame equals the JAX island kernel's."""
    trans, params, ys = _island_args()
    spec, gt = _discrete_port(params, 2, trans, [-1.0, 1.0], [1.0, 1.0], [0.5, 0.5])
    states, w0 = torch.zeros(N, dtype=torch.int32), torch.zeros(N)
    ctrl = torch.tensor([0, 0, 8], dtype=torch.int32)
    draws = (torch.zeros(8, N), torch.full((1, 1), 0.5))
    base = guided_chunk_plain(0, states, w0, torch.as_tensor(ys), ctrl, spec, gt,
                              t0=0, island_size=N, draws=draws)
    isl = guided_chunk_plain(0, states, w0, torch.as_tensor(ys), ctrl, spec, gt,
                             t0=0, island_every=4, island_thresh=0.0,
                             island_size=N, draws=draws)
    assert torch.equal(base[0], isl[0]) and torch.equal(base[1], isl[1])
    assert float(isl[2][:, -1].sum()) == 0.0
    ref = ref_attach_discrete(trans, [-1.0, 1.0], [1.0, 1.0], [0.5, 0.5],
                              params=params, T=T, block_r=8, interpret=True,
                              island_every=4, island_thresh=0.0)
    s_r, w_r, *_ = ref.fused_chunk_exchange_t_batch(
        jax.random.key(0), jnp.zeros(N, jnp.int32), jnp.zeros(N), jnp.asarray(ys),
        jnp.int32(8), jnp.int32(0), jnp.zeros((1,), jnp.int32), jnp.int32(0))
    np.testing.assert_array_equal(isl[0].numpy(), np.asarray(s_r))
    np.testing.assert_allclose(isl[1].numpy(), np.asarray(w_r), rtol=1e-5, atol=2e-5)


def test_guided_island_forced_trigger_resets_block():
    """tests/test_pallas_ssm.py:613-630: a forced check resamples the
    island to equal weights (the island's log-mean weight), as the JAX
    island kernel does."""
    trans, params, ys = _island_args()
    spec, gt = _discrete_port(params, 2, trans, [-1.0, 1.0], [1.0, 1.0], [0.5, 0.5])
    ctrl = torch.tensor([0, 0, 8], dtype=torch.int32)
    s, w, rec = guided_chunk_plain(
        0, torch.zeros(N, dtype=torch.int32), torch.zeros(N), torch.as_tensor(ys),
        ctrl, spec, gt, t0=0, island_every=4, island_thresh=2.0, island_size=N,
        draws=(torch.zeros(8, N), torch.full((1, 1), 0.5)))
    ess = float(stats_from_partials(rec, N)[0])
    assert torch.isfinite(w).all()
    assert ess == pytest.approx(N, rel=1e-6)
    assert float(w.max() - w.min()) < 1e-5
    assert float(rec[0, -1]) == 1.0
    ref = ref_attach_discrete(trans, [-1.0, 1.0], [1.0, 1.0], [0.5, 0.5],
                              params=params, T=T, block_r=8, interpret=True,
                              island_every=4, island_thresh=2.0)
    s_r, w_r, ess_r, *_ = ref.fused_chunk_exchange_t_batch(
        jax.random.key(0), jnp.zeros(N, jnp.int32), jnp.zeros(N), jnp.asarray(ys),
        jnp.int32(8), jnp.int32(0), jnp.zeros((1,), jnp.int32), jnp.int32(0))
    assert float(ess_r) == N
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-5, atol=2e-5)


def test_guided_discrete_hooks_launch_the_guided_kernel_on_cpu_plain():
    """The chunk and per-step hooks go through ``guided_chunk`` (on the
    CPU: its plain version) and never through the unguided chunk."""
    K = 5
    params = mlp_params_from_numpy(_net([K + 2, 8, 8, K], 11), device="cpu")
    g = attach_fused_guided_discrete_kernels(TRANS5, MEANS5, STDS5, INIT5,
                                             params=params, T=T)
    assert g.fused_hooks_guided and g.fused_step_batch is None
    assert g.fused_chunk_exchange_batch is None
    n = fused_hmm.ISLAND_SIZE
    s0 = torch.zeros(n, dtype=torch.int32)
    w0 = torch.zeros(n)
    flag = torch.tensor(0, dtype=torch.int32)
    ticks = torch.zeros(K - 1, dtype=torch.int32)
    out = g.fused_step_exchange_batch(3, s0, w0, torch.tensor(0.4), 2, flag, ticks)
    spec, gt = _discrete_port(params)
    want = guided_chunk(3, s0, w0, torch.tensor([0.4]),
                        torch.tensor([0, 0, 0, 0, 0, 1], dtype=torch.int32),
                        spec, gt, t0=2)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    s, w, ess = g.fused_step_ess_batch(3, s0, w0, torch.tensor(0.4), 2)
    assert torch.equal(s, want[0]) and torch.equal(w, want[1])


# --------------------------------------------------------------------------
# validation


def test_guided_builders_reject_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="normal"):
        attach_fused_guided_scalar_kernels(
            linear_gaussian_ssm, _net([4, 8, 2], 0), T,
            trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    with pytest.raises(ValueError, match="normal"):
        GuidedScalarKernel(_net([3, 8, 3], 0), trans_lp, obs_lp, T)
    with pytest.raises(ValueError, match="chain"):
        GuidedScalarKernel([{"w": np.zeros((3, 4)), "b": np.zeros(4)},
                            {"w": np.zeros((5, 2)), "b": np.zeros(2)}],
                           trans_lp, obs_lp, T)
    with pytest.raises(ValueError, match="K <= 8"):
        attach_fused_guided_discrete_kernels(np.full((9, 9), 1 / 9), np.arange(9.0),
                                             params=_net([11, 8, 9], 0), T=T)
    # K = 1 is served; a net deeper than the kernel's NetDims is not
    assert attach_fused_guided_discrete_kernels(
        [[1.0]], [0.0], params=_net([3, 4, 1], 0), T=T).fused_hooks_guided
    with pytest.raises(ValueError, match="at most 32 layers"):
        attach_fused_guided_discrete_kernels([[1.0]], [0.0],
                                             params=_net([3] + [4] * 32 + [1], 0), T=T)
    with pytest.raises(ValueError, match="discrete"):
        attach_fused_guided_discrete_kernels(TRANS5, MEANS5, STDS5, INIT5,
                                             params=_net([8, 8, 5], 0), T=T)
    # the widest layer the shared memory holds, and one unit more
    widest = fused_hmm.guided_max_width(5)
    assert widest == (232448 - 3072) // 40
    GuidedTables.from_params(np.log(TRANS5), _zero_net([7, widest, 5]), T)
    with pytest.raises(ValueError, match=f"shared memory.*at most {widest} units"):
        attach_fused_guided_discrete_kernels(TRANS5, MEANS5, STDS5, INIT5,
                                             params=_zero_net([7, widest + 1, 5]), T=T)


def _zero_net(sizes):
    return [{"w": np.zeros((a, b), np.float32), "b": np.zeros(b, np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _captures_tensor(x, nx, t):
    return x * _TENSOR


_TENSOR = torch.ones(1)


def _two_args(x, nx):
    return x - nx


def _imports(nx, y, t):
    import math as m  # noqa: F401
    return nx - y


def _outside(nx, y, t):
    return elem.erf(nx - y)


@pytest.mark.parametrize("bad,which", [
    (lambda x, nx, t: x - nx, "trans"), (_captures_tensor, "trans"),
    (_two_args, "trans"), (_imports, "obs"), (_outside, "obs")])
def test_density_hooks_outside_the_contract_raise(bad, which):
    kw = dict(trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    kw[f"{which}_logpdf_elem"] = bad
    with pytest.raises(ValueError):
        attach_fused_guided_scalar_kernels(linear_gaussian_ssm,
                                           _net([3, 8, 8, 2], 0), T, **kw)


def test_density_hooks_take_the_absolute_step():
    """``t`` reaches the densities as the absolute step (float32)."""
    seen = []

    def obs_t(nx, y, t):
        seen.append(float(t))
        d = y - nx
        return -0.5 * d * d - half_log_2pi

    params = mlp_params_from_numpy(_net([3, 4, 2], 1), device="cpu")
    guided_scalar_chunk_plain(params, trans_lp, obs_t, T, 0, torch.zeros(8),
                              torch.zeros(8), torch.zeros(3), t0=5)
    assert seen == [5.0, 6.0, 7.0]


@pytest.mark.cuda
def test_guided_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K12 and K13 run only on the card")
    dev = torch.device("cuda")
    params = mlp_params_from_numpy(_net([3, 8, 8, 2], 2), dev)
    k = GuidedScalarKernel(params, trans_lp, obs_lp, T)
    x0 = torch.randn(1 << 16, device=dev)
    w0 = torch.zeros(1 << 16, device=dev)
    ys = torch.tensor([0.5, -0.25, 1.1], device=dev)
    got = k.chunk(1, x0, w0, ys, t0=1)
    want = guided_scalar_chunk_plain(params, trans_lp, obs_lp, T, 1, x0, w0, ys, t0=1)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    spec, gt = _discrete_port(_net([7, 8, 8, 5], 6))
    n = 4 * fused_hmm.ISLAND_SIZE
    s0 = torch.randint(0, 5, (n,), dtype=torch.int32, device=dev)
    ctrl = torch.tensor([0, 0, 0, 0, 0, 3], dtype=torch.int32, device=dev)
    got = guided_chunk(1, s0, torch.zeros(n, device=dev), ys, ctrl, spec, gt)
    want = guided_chunk_plain(1, s0, torch.zeros(n, device=dev), ys, ctrl, spec, gt)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
