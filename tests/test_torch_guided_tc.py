"""K12's tensor-core twin (``cpprob_tpu_torch.ops.guided_tc``): the packed
weights replayed against the plain net, the densities rendered to C++ (and,
where a host compiler exists, compiled and held to the Python functions),
the limits, and ``attach_fused_guided_scalar_kernels(..., mxu=...)``.

The kernel itself runs only on a CUDA card (``cuda``-marked tests); on the
CPU the wrapper runs the plain version, which the JAX package's twins are
held to in ``tests/test_torch_guided_kernels.py``.
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cpprob_tpu_torch.interop import mlp_params_from_numpy
from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm
from cpprob_tpu_torch.ops import calibrate as cal
from cpprob_tpu_torch.ops import elem, guided_tc
from cpprob_tpu_torch.ops.elem import exp, where
from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels
from cpprob_tpu_torch.ops.guided_scalar import (
    GuidedScalarKernel,
    _net_plain,
    guided_scalar_chunk_plain,
)
from cpprob_tpu_torch.ops.guided_tc import (
    GuidedTensorCoreKernel,
    pack_weights,
    render_density,
    tc_net_plain,
    tf32_round,
)
from cpprob_tpu_torch.util import roofline as rl

torch.set_num_threads(2)

half_log_2pi = 0.9189385332046727
SCALE = 0.5


def trans_lp(x, nx, t):
    d = nx - x
    return -0.5 * d * d - half_log_2pi


def obs_lp(nx, y, t):
    d = y - nx
    return -0.5 * d * d - half_log_2pi


def every_elem(x, nx, t):
    """Every elem function, where, a comparison, a tuple unpack, a captured
    number and math.pi."""
    a, b = elem.exp(-x) / 2, elem.log(nx * nx + 1.0)
    c = elem.sqrt(a + b) + elem.sin(t) * elem.cos(math.pi * x) - elem.tanh(nx)
    c += SCALE
    lo = elem.minimum(a, b)
    hi = elem.maximum(a, 3)
    return where(x > nx, c * lo, exp(hi) - c)


def arithmetic(x, nx, t):
    """Arithmetic only: bit-equal on a host compiler."""
    a, b = (nx - x) / (t + 1.5), -x * SCALE
    b -= math.pi * a
    keep = a >= b
    return where(keep, a * b + x / 3, b - a * (nx + 2)) + 1.0


def power(x, nx, t):
    return -(nx - x) ** 2


def powers(x, nx, t):
    """Every rendering of ``**``: 2, 3, 0.5 and -1 as torch computes them,
    any other exponent (a captured number here) through ``powf``."""
    d = nx - x
    return d ** 2 + d ** 3 + (x * x + 1.0) ** 0.5 - (nx * nx + 2.0) ** -1 + 0.0 * (x * x) ** GAIN


GAIN = 1.5


def chained(x, nx, t):
    return where(0.0 < x < 1.0, x, nx)


def branch(x, nx, t):
    if x > 0:
        return x
    return nx


def _net(sizes, seed, raw_bias=0.5, scale=0.4):
    rng = np.random.default_rng(seed)
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers.append({"w": (scale * rng.standard_normal((a, b))).astype(np.float32),
                       "b": (0.1 * rng.standard_normal(b)).astype(np.float32)})
    layers[-1]["b"][1] += raw_bias
    return layers


# --------------------------------------------------------------------------
# the packing


@pytest.mark.parametrize("sizes", [[3, 16, 16, 2], [3, 8, 8, 2], [3, 24, 24, 2],
                                   [3, 16, 16, 16, 2], [3, 5, 2], [3, 32, 32, 2],
                                   [3, 13, 2], [3, 8, 16, 8, 2], [3, 32, 32, 32, 2]])
def test_packed_replay_matches_the_plain_net(sizes):
    """The kernel's arithmetic replayed from the packed, permuted and split
    weights (3xTF32 products, C->A reuse, the output layer on the FMA pipe)
    against ``_net_plain``, within 1e-6 relative to
    the magnitude of the terms each output sums (the net run on |W|, |b|
    and |activations| in float64, the scale of a float32 sum's rounding):
    float32-level.  Outputs near 0 after cancellation keep only that
    absolute accuracy in any order of summation."""
    layers = _net(sizes, 1)
    Ws = [lay["w"] for lay in layers]
    bs = [lay["b"] for lay in layers]
    packed = torch.as_tensor(pack_weights(Ws, bs))
    x = torch.as_tensor(np.random.default_rng(2).normal(0, 2, 4096).astype(np.float32))
    y, tf = torch.tensor(0.7), torch.tensor(3.0) / 16.0
    got = tc_net_plain(packed, sizes, x, y, tf)
    net = ([torch.as_tensor(W) for W in Ws], [torch.as_tensor(b) for b in bs])
    want = _net_plain(net, x, y, tf)
    # the scale of the summed terms, layer by layer
    Wd = [W.double() for W in net[0]]
    bd = [b.double() for b in net[1]]
    act = torch.relu(x.double()[:, None] * Wd[0][0] + (Wd[0][1] * 0.7 + Wd[0][2] * float(tf)
                                                       + bd[0]))
    scale = act.abs()
    for i in range(1, len(Wd)):
        pre = act @ Wd[i] + bd[i]
        scale = scale @ Wd[i].abs() + bd[i].abs()
        act = torch.relu(pre)
    for k, (g, w) in enumerate(zip(got, want)):
        rel = ((g - w).double().abs() / scale[:, k]).max()
        assert float(rel) <= 1e-6, float(rel)


def test_packing_layout_and_the_tf32_split():
    sizes = [3, 16, 24, 2]
    layers = _net(sizes, 3)
    Ws, bs = [lay["w"] for lay in layers], [lay["b"] for lay in layers]
    buf = pack_weights(Ws, bs)
    # the header's layer_floats(): 4 H1, then per hidden->hidden layer N + 2
    # K N, the output layer 4 + 2 K
    assert buf.shape == (4 * 16 + (24 + 2 * 16 * 24) + (4 + 2 * 24),)
    np.testing.assert_array_equal(buf[-52:-48], [*layers[-1]["b"], 0, 0])
    np.testing.assert_array_equal(buf[-48:].reshape(24, 2), layers[-1]["w"])
    assert guided_tc.padded_sizes([3, 5, 13, 2]) == [3, 8, 16, 2]
    # cvt.rna.tf32: 10 mantissa bits, ties away from zero
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                     np.inf, 3.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, np.inf, 3.0], np.float32)
    np.testing.assert_array_equal(tf32_round(vals), want)
    w = np.random.default_rng(4).standard_normal(1000).astype(np.float32)
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    assert np.all(np.abs(w - (hi + lo)) <= np.abs(w) * 2.0 ** -21)
    # the first layer unpadded; the hidden layer's biases, then its B
    # fragments: lane (g, t) of block (kb, nb) holds rows 8 kb + 2t and
    # 8 kb + 2t + 1 of column 8 nb + g, hi then lo
    first = buf[:64].reshape(16, 4)
    np.testing.assert_array_equal(first[:, 0], layers[0]["w"][0])
    np.testing.assert_array_equal(first[:, 3], layers[0]["b"])
    np.testing.assert_array_equal(buf[64:88], layers[1]["b"])
    frag = buf[88:88 + 2 * 16 * 24].reshape(2, 3, 32, 4)
    W = layers[1]["w"]
    w_hi = tf32_round(W)
    w_lo = tf32_round(W - w_hi)
    for kb, nb, lane in ((0, 0, 0), (1, 2, 31), (0, 1, 13), (1, 0, 6)):
        g, t = lane >> 2, lane & 3
        r, c = 8 * kb + 2 * t, 8 * nb + g
        np.testing.assert_array_equal(frag[kb, nb, lane], [w_hi[r, c], w_hi[r + 1, c],
                                                           w_lo[r, c], w_lo[r + 1, c]])


def test_tc_bound_counts_the_function():
    """3xTF32 multiply-adds of the hidden->hidden layers; on the FMA pipe
    the first layer (3 a unit), ReLU, the output layer (2 x 2 a weight) and
    the tail (14), not the splits or the quad's adds."""
    c = rl.guided_tc_ops([3, 16, 16, 2])
    assert c == {"tf32_macs": 3 * 16 * 16, "f32_ops": 48 + 16 + 64 + 14}
    assert rl.guided_tc_ops([3, 5, 2]) == {"tf32_macs": 0, "f32_ops": 24 + 32 + 14}
    c = rl.guided_tc_ops([3, 8, 13, 2])
    assert c == {"tf32_macs": 3 * 8 * 16, "f32_ops": 24 + 16 + 64 + 14}
    b = rl.bound(0, 0, tf32_macs=247.5e12)
    assert b["bound_ms"] == pytest.approx(1e3) and b["counts"] == {"tf32_macs": 247.5e12}
    rates = rl.calibrated_rates({"fp32_flops_per_s": 5e13,
                                 "tensor_core_bf16_macs_per_s": 4e14,
                                 "hbm_marginal_bytes_per_s": 3e12,
                                 "philox_calls_per_s": 5e11,
                                 "normal_variates_per_s": 4e11,
                                 "exp_log1p_pairs_per_s": 9e11})
    assert rates["tf32_macs"] == 2e14


# --------------------------------------------------------------------------
# the densities in C++


def test_renders_the_test_densities():
    src = render_density(trans_lp, "trans_logpdf_elem", "x, nx, t", "_kt_")
    assert src == (
        "__device__ __forceinline__ float trans_logpdf_elem(float v_x, float v_nx, "
        "float v_t) {\n"
        "  auto v_d = __fsub_rn(v_nx, v_x);\n"
        "  return __fsub_rn(__fmul_rn(__fmul_rn((-0.5f), v_d), v_d), "
        "0.9189385175704956f);\n}\n")
    src = render_density(obs_lp, "obs_logpdf_elem", "nx, y, t", "_ko_")
    assert "__fsub_rn(v_y, v_nx)" in src


def test_renders_every_elem_function():
    src = render_density(every_elem, "trans_logpdf_elem", "x, nx, t", "_kt_")
    for piece in ("expf(", "logf(", "__fsqrt_rn(", "sinf(", "cosf(", "tanhf(",
                  "fminf(", "fmaxf(", "__fdiv_rn(", " ? ", "(v_x > v_nx)",
                  "const auto tu0 =", "const auto tu1 =", "auto v_a = tu0;",
                  "auto v_b = tu1;", "v_c = __fadd_rn(v_c, 0.5f);",
                  f"{float(np.float32(math.pi))!r}f", "3.0f", "(-v_x)"):
        assert piece in src, piece
    assert "All of it" not in src


@pytest.mark.parametrize("fn,what", [(power, "Pow"), (chained, "chained"),
                                     (branch, "If")])
def test_renderer_rejects_with_a_pointer_to_the_triton_twin(fn, what):
    """``**`` with a number exponent renders and builds both twins of K12;
    chained comparisons and ``if`` raise for both, naming the construct and
    the contract."""
    params = mlp_params_from_numpy(_net([3, 8, 8, 2], 0), device="cpu")
    kw = dict(trans_logpdf_elem=fn, obs_logpdf_elem=obs_lp)
    if fn is power:
        src = render_density(fn, "trans_logpdf_elem", "x, nx, t", "_kt_")
        assert "(-__fmul_rn(__fsub_rn(v_nx, v_x), __fsub_rn(v_nx, v_x)))" in src
        for mxu, cls in ((True, GuidedTensorCoreKernel), (False, GuidedScalarKernel)):
            model = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, params, 8,
                                                       mxu=mxu, **kw)
            assert isinstance(model.fused_chunk_t_batch.kernel, cls)
            assert "__fmul_rn(__fsub_rn(v_nx, v_x)" in model.fused_chunk_t_batch.kernel.source()
        return
    with pytest.raises(ValueError, match=f"(?s){what}.*elementwise contract"):
        render_density(fn, "trans_logpdf_elem", "x, nx, t", "_kt_")
    for mxu in (True, False):
        with pytest.raises(ValueError, match="elementwise contract"):
            attach_fused_guided_scalar_kernels(linear_gaussian_ssm, params, 8, mxu=mxu, **kw)


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
"""


def _host_library(tmp_path, fns):
    """The rendered densities compiled as host C++ (no contraction), each
    as ``run_<i>(a, b, c, out, n)``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = _PRELUDE
    for i, fn in enumerate(fns):
        src += render_density(fn, f"density_{i}", "a, b, t", "_kt_")
        src += (f'extern "C" void run_{i}(const float* a, const float* b, '
                f'const float* c, float* out, int n) {{\n'
                f'  for (int i = 0; i < n; ++i) out[i] = density_{i}(a[i], b[i], c[i]);\n}}\n')
    (tmp_path / "d.cpp").write_text(src)
    lib = tmp_path / "libd.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", str(lib), str(tmp_path / "d.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _run_host(lib, i, a, b, c):
    out = np.empty_like(a)
    p = ctypes.POINTER(ctypes.c_float)
    getattr(lib, f"run_{i}")(*(v.ctypes.data_as(p) for v in (a, b, c, out)),
                             ctypes.c_int(a.shape[0]))
    return out


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _exp_d(x, nx, t):
    return elem.exp(x)


def _log_d(x, nx, t):
    return elem.log(nx)


def _sin_d(x, nx, t):
    return elem.sin(x)


def _cos_d(x, nx, t):
    return elem.cos(x)


def _tanh_d(x, nx, t):
    return elem.tanh(x)


def _sqrt_d(x, nx, t):
    return elem.sqrt(nx)


def _pow_d(x, nx, t):
    return x ** 2 + nx ** 3 - (nx * 0.5) ** -1


def _half_d(x, nx, t):
    return nx ** 0.5


def test_powers_render_as_torch_rounds_them(tmp_path):
    """``a ** c`` on the host compiler: for c = 2, 3 and -1 bit-equal to
    torch's float32 ``pow`` (which computes a * a, a * a * a and 1 / a);
    for c = 0.5 the rendering is ``__fsqrt_rn``, torch's ``x ** 0.5`` is
    ``torch.sqrt`` bit for bit, and the host's correctly rounded ``sqrtf``
    is within an ulp of it (torch's vectorized CPU square root is not
    always correctly rounded; on the card both sides take CUDA's); any
    other exponent is ``powf``."""
    src = render_density(powers, "trans_logpdf_elem", "x, nx, t", "_kt_")
    for piece in ("__fmul_rn(v_d, v_d)", "__fmul_rn(__fmul_rn(v_d, v_d), v_d)",
                  "__fsqrt_rn(", "__frcp_rn(", "powf(", "1.5f)"):
        assert piece in src, piece
    lib = _host_library(tmp_path, [_pow_d, _half_d])
    rng = np.random.default_rng(4)
    n = 20000
    a = rng.normal(0, 2, n).astype(np.float32)
    b = np.abs(rng.normal(0, 3, n)).astype(np.float32) + np.float32(1e-3)
    c = np.zeros(n, np.float32)
    want = _pow_d(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(_run_host(lib, 0, a, b, c), want)
    tb = torch.as_tensor(b)
    assert torch.equal(tb ** 0.5, torch.sqrt(tb))
    assert _ulps(_run_host(lib, 1, a, b, c), (tb ** 0.5).numpy()).max() <= 1


def test_rendered_densities_compile_and_agree_on_the_host(tmp_path):
    """Arithmetic bit for bit (the test densities and ``arithmetic``, with
    division, where, a comparison, tuples, captured numbers and math.pi);
    each transcendental and the square root within 2 ulp of torch's (the
    host libm against torch's vectorized CPU kernels, whose float32 sqrt is
    not always correctly rounded; on the card both sides take CUDA's)."""
    exact = [trans_lp, obs_lp, arithmetic]
    close = [_sqrt_d, _exp_d, _log_d, _sin_d, _cos_d, _tanh_d]
    lib = _host_library(tmp_path, exact + close)
    rng = np.random.default_rng(6)
    n = 20000
    a = rng.normal(0, 2, n).astype(np.float32)
    b = np.abs(rng.normal(0, 3, n)).astype(np.float32) + np.float32(1e-3)
    c = rng.integers(0, 64, n).astype(np.float32)
    for i, fn in enumerate(exact + close):
        host = _run_host(lib, i, a, b, c)
        want = fn(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
        if fn in exact:
            np.testing.assert_array_equal(host, want, err_msg=fn.__name__)
        else:
            assert _ulps(host, want).max() <= 2, fn.__name__


# --------------------------------------------------------------------------
# the surface


def test_mxu_selects_the_twin_and_both_run_the_plain_version_on_cpu():
    params = mlp_params_from_numpy(_net([3, 8, 8, 2], 4), device="cpu")
    kw = dict(trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    tc = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, params, 8, **kw)
    tri = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, params, 8,
                                             mxu=False, **kw)
    assert isinstance(tc.fused_chunk_t_batch.kernel, GuidedTensorCoreKernel)
    assert isinstance(tri.fused_chunk_t_batch.kernel, GuidedScalarKernel)
    x0 = torch.linspace(-2, 2, 2048)
    w0 = torch.zeros(2048)
    ys = torch.tensor([0.3, -0.2, 0.9])
    nv = torch.tensor(2, dtype=torch.int32)
    out_tc = tc.fused_chunk_t_batch(5, x0, w0, ys, nv, 3)
    out_tri = tri.fused_chunk_t_batch(5, x0, w0, ys, nv, 3)
    for a, b in zip(out_tc, out_tri):
        assert torch.equal(a, b)
    want = guided_scalar_chunk_plain(params, trans_lp, obs_lp, 8, 5, x0, w0, ys, nv, t0=3)
    assert torch.equal(out_tc[0], want[0]) and torch.equal(out_tc[1], want[1])
    # a linear head takes K12 on the FMA pipe whatever mxu says
    head = mlp_params_from_numpy(_net([3, 2], 5), device="cpu")
    lin = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, head, 8, **kw)
    assert isinstance(lin.fused_chunk_t_batch.kernel, GuidedScalarKernel)


def test_width_limit_and_validation():
    """The limit is the trainer's default width, 64: one unit past it
    raises and names ``mxu=False``, which takes it; a 64-wide net builds
    the twin by default, in the wide layout (two particles a thread with
    one hidden->hidden layer, one with more), and nets up to 32 wide keep
    the narrow one (two a thread)."""
    over = mlp_params_from_numpy(_net([3, 65, 2], 6), device="cpu")
    kw = dict(trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    with pytest.raises(ValueError, match=r"limit of 64 \(guided_tc_max_width\(\)\).*mxu=False"):
        attach_fused_guided_scalar_kernels(linear_gaussian_ssm, over, 8, **kw)
    model = attach_fused_guided_scalar_kernels(linear_gaussian_ssm, over, 8, mxu=False, **kw)
    assert isinstance(model.fused_chunk_t_batch.kernel, GuidedScalarKernel)
    assert guided_tc.guided_tc_max_width() == 64
    wide = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, mlp_params_from_numpy(_net([3, 64, 64, 2], 6), device="cpu"),
        8, **kw).fused_chunk_t_batch.kernel
    assert isinstance(wide, GuidedTensorCoreKernel) and wide.wide
    assert guided_tc.groups([3, 64, 64, 2]) == 2 and wide.block() == 512
    assert guided_tc.groups([3, 64, 64, 64, 2]) == 1 == guided_tc.groups([3, 40, 2])
    assert "constexpr int kWidths[kLayers + 1] = {3, 64, 64, 2};" in wide.source()
    for sizes, is_wide in (([3, 33, 2], True), ([3, 40, 2], True), ([3, 16, 48, 2], True),
                           ([3, 32, 32, 32, 2], False)):
        assert guided_tc.is_wide(sizes) is is_wide
    k = GuidedTensorCoreKernel(mlp_params_from_numpy(_net([3, 32, 32, 2], 7), device="cpu"),
                               trans_lp, obs_lp, 8)
    assert guided_tc.GROUPS == 2 and k.block() == 512 and not k.wide
    k = GuidedTensorCoreKernel(mlp_params_from_numpy(_net([3, 16, 16, 2], 7), device="cpu"),
                               trans_lp, obs_lp, 8)
    assert k.block() == 512 and k.layer_sizes() == [3, 16, 16, 2]
    src = k.source()
    assert "constexpr int kWidths[kLayers + 1] = {3, 16, 16, 2};" in src
    assert '#include "guided_tc.cuh"' in src
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="draws="):
        k.chunk(0, x.to("meta"), x.to("meta"), torch.zeros(2, device="meta"),
                draws=torch.zeros(2, 1))


def test_calibrate_hbm_plain_and_validation():
    """K19 on a CPU tensor is its plain version; a length that is not a
    multiple of 4 raises before any launch, as does a device other than
    the CPU or a card."""
    x = torch.arange(8, dtype=torch.float32)
    assert torch.equal(cal.calibrate_hbm(x), x + 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        cal.calibrate_hbm(torch.zeros(6, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        cal.calibrate_hbm(torch.zeros(8, device="meta"))


# --------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tensor-core twin and K19 run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,t0,nv", [([3, 16, 16, 2], 1, 8), ([3, 16, 16, 2], 9, 7),
                                         ([3, 24, 24, 2], 2, 8), ([3, 16, 16, 16, 2], 1, 5)])
def test_tensor_core_twin_matches_plain_on_the_card(sizes, t0, nv):
    """One step against the plain version within chip_smoke.py's
    TC_STEP_TOL of 1 + |plain| (3xTF32 products and another order of
    summation in the net); the chunk of ``nv`` steps against the same
    steps launched one at a time, bit for bit."""
    dev = _card()
    n = (1 << 16) + 77
    params = mlp_params_from_numpy(_net(sizes, 8), device=dev)
    k = GuidedTensorCoreKernel(params, trans_lp, obs_lp, 16)
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn(n, generator=gen, device=dev)
    w0 = 0.1 * torch.randn(n, generator=gen, device=dev)
    ys = torch.randn(8, generator=gen, device=dev)
    one = torch.tensor(1, dtype=torch.int32, device=dev)
    xk, wk, _ = k.chunk(3, x0, w0, ys, one, t0=t0)
    xp, wp, _ = guided_scalar_chunk_plain(params, trans_lp, obs_lp, 16, 3, x0, w0, ys,
                                          one, t0=t0)
    torch.cuda.synchronize()
    for a, b in ((xk, xp), (wk, wp)):
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= 2e-5
    n_valid = torch.tensor(nv, dtype=torch.int32, device=dev)
    xc, wc, rc = k.chunk(3, x0, w0, ys, n_valid, t0=t0)
    x, w = x0, w0
    for s in range(nv):
        x, w, r = k.chunk(3, x, w, ys[s:], one, t0=t0 + s)
    assert torch.equal(xc, x) and torch.equal(wc, w) and torch.equal(rc, r)
    assert rc.shape == (-(-n // k.block()), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, (1 << 20) + 12])
def test_add_one_kernel_on_the_card(n):
    dev = _card()
    x = torch.randn(n, device=dev)
    assert torch.equal(cal.calibrate_hbm(x), cal.calibrate_hbm_plain(x))


def test_parts_variants_find_their_lines():
    """``util/guided_tc_parts.py`` (the card's breakdown of the twin's time)
    builds its variants by substituting lines of the header: each still
    finds its line, and only ``full`` is the header unchanged."""
    from pathlib import Path

    from cpprob_tpu_torch.util import guided_tc_parts

    src = (Path(guided_tc.__file__).parent / "csrc" / "guided_tc.cuh").read_text()
    variants = guided_tc_parts.variant_sources(src)
    assert set(variants) == set(guided_tc_parts.VARIANTS)
    assert [k for k, v in variants.items() if v == src] == ["full"]
    assert variants["double_mma"].count("mma.sync.aligned") == 2
    assert "lo = 0u;" in variants["one_tf32"] and "bl0 = 0u, bl1 = 0u;" in variants["one_tf32"]
    with pytest.raises(ValueError, match="is gone"):
        guided_tc_parts.variant_sources(src.replace("0xffffe000u", "0xFFFFE000u"))


def test_parts_k12_designs_carry_their_substitutions():
    """``util/guided_tc_parts.py``'s K12 designs: the kept one is the
    kernel object's own source; the others change the particles a thread
    (with the block the wrapper expects) or read every weight from a
    kernel-parameter struct in place of the literals, the header pasted in
    with the struct threaded through the kernel and its launch."""
    from cpprob_tpu_torch.ops import guided_scalar as gs
    from cpprob_tpu_torch.util import guided_tc_parts

    params = mlp_params_from_numpy(_net([3, 16, 16, 2], 9), device="cpu")
    kept = gs.GuidedScalarKernel(params, trans_lp, obs_lp, 16)
    designs = {name: guided_tc_parts.k12_design(name, params, trans_lp, obs_lp, 16)
               for name in guided_tc_parts.K12_DESIGNS}
    assert designs["K12"].source() == kept.source() and kept.block() == 1024
    for p in (1, 2):
        k = designs[f"K12 {p} a thread"]
        assert f"constexpr int kPerThread = {p};" in k.source() and k.block() == 256 * p
    assert "constexpr int kPerThread = 2;" in designs["K12 weights as parameters, 2 a thread"].source()
    src = designs["K12 weights as parameters"].source()
    n_weights = sum(lay["w"].size + lay["b"].size for lay in _net([3, 16, 16, 2], 9))
    assert f"struct Weights {{ float v[{n_weights}]; }};" in src
    assert f"kw.v[{n_weights - 1}]" in src and '#include "guided_scalar.cuh"' not in src
    assert "long long n, const Weights kw)" in src and "memcpy(&kw, host_w" in src
    body = src.split("void first_consts(")[1].split("#include")[0].split("trans_logpdf_elem")[0]
    assert set(re.findall(r"-?\d+\.\d+(?:e-?\d+)?f", body)) == {"0.0f"}


def test_parts_variant_kernel_pastes_its_header():
    """The kernel object of a variant generates the twin's source with the
    variant's header pasted in place of the include, and builds under its
    own hash; its weights and checks are the twin's."""
    from cpprob_tpu_torch.util import guided_tc_parts

    params = mlp_params_from_numpy(_net([3, 16, 16, 2], 9), device="cpu")
    k = guided_tc_parts.variant_kernel("one_tf32", params, trans_lp, obs_lp, 16)
    twin = GuidedTensorCoreKernel(params, trans_lp, obs_lp, 16)
    src = k.source()
    assert '#include "guided_tc.cuh"' not in src and "lo = 0u;" in src
    assert src.startswith(twin.source().split('#include "guided_tc.cuh"')[0])
    assert torch.equal(k.packed(), twin.packed())

