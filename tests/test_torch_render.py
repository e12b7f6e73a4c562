"""The elementwise contract and its C++ renderer (``cpprob_tpu_torch.ops.
render``), shared by the user-physics kernels (K10, K11) and K12's
tensor-core twin.

The renderer runs on the CPU.  A rendered ``step_elem`` is compiled here as
host C++ (no contraction, the round-to-nearest intrinsics as plain float
operations) and held to the plain version on torch tensors: the
arithmetic-only physics bit for bit.  Each construct outside the contract
raises ``ValueError`` naming it when the kernel object is built.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cpprob_tpu_torch.ops import elem
from cpprob_tpu_torch.ops.elem import minimum, where
from cpprob_tpu_torch.ops.fused_ssm import attach_fused_scalar_kernels
from cpprob_tpu_torch.models.linear_gaussian import linear_gaussian_ssm
from cpprob_tpu_torch.ops.render import analyse_step_elem, render_function
from cpprob_tpu_torch.ops.user_chunk import UserKernel

torch.set_num_threads(2)

half_log_2pi = 0.9189385332046727
LOG_SD = math.log(0.6)
GAIN = 2
CLAMP = True


def lg_step_elem(x, y, eps):
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - half_log_2pi


def growth_step_elem(x, y, eps):
    """A non-linear physics: bounded growth, a tanh observation."""
    nx = 0.7 * x + GAIN * elem.sin(x) + 0.5 * eps
    h = elem.tanh(nx)
    d = (y - minimum(h, 2.0)) / 0.6
    return nx, -0.5 * d * d - LOG_SD - half_log_2pi


def lg2d_step_elem(x0, x1, y, e0, e1):
    n0 = 0.9 * x0 + 0.1 * x1 + e0
    n1 = 0.8 * x1 + e1
    d = y - (n0 + n1)
    return n0, n1, -0.5 * d * d - half_log_2pi


def every_step_elem(x, y, eps):
    """Every elem function, where, comparisons, tuple unpacking, an
    augmented assignment, a captured bool and int, math.pi."""
    a, b = elem.exp(-x) / 2, elem.log(x * x + 1.0)
    c = elem.sqrt(a + b) + elem.cos(math.pi * x) - elem.tanh(eps)
    c += GAIN
    lo = elem.minimum(a, b)
    hi = elem.maximum(a, 3)
    nx = where(x > y, c * lo, elem.exp(-hi) - c) + eps
    nx = where(CLAMP, nx, x)
    return nx, -(nx - y) * (nx - y) + where(nx <= 0.0, 1.0, 0.0)


def arithmetic_step_elem(x0, x1, y, e0, e1):
    """Arithmetic only, on two planes: bit-equal on a host compiler."""
    a, b = (x1 - x0) / (y + 1.5), -x0 * GAIN
    b -= math.pi * a
    n0 = where(a < b, a + e0, b - e1)
    n1 = +x1 * 0.25 + e1 / 3
    return n0, n1, (n0 - y) * (n1 - y) / 7


def _outs(fn, D):
    src, consts = analyse_step_elem(fn, D)
    return render_function(src, consts, "_k_", outs=D + 1, hint="the hint")


@pytest.mark.parametrize("fn,D", [(lg_step_elem, 1), (growth_step_elem, 1),
                                  (lg2d_step_elem, 2), (every_step_elem, 1),
                                  (arithmetic_step_elem, 2)])
def test_renders_the_physics(fn, D):
    cpp = _outs(fn, D)
    outs = ", ".join(f"float& o_{i}" for i in range(D + 1))
    assert cpp.startswith("__device__ __forceinline__ void step_elem(")
    assert outs + ") {" in cpp
    assert cpp.rstrip().endswith("return;\n}")
    assert f"o_{D} = tu" in cpp
    assert UserKernel(fn, D).source().count("step_elem(") == 2


def test_renders_every_construct():
    cpp = _outs(every_step_elem, 1)
    for piece in ("expf(", "logf(", "__fsqrt_rn(", "cosf(", "tanhf(", "fminf(",
                  "fmaxf(", "__fdiv_rn(", " ? ", "(v_x > v_y)", "(v_nx <= 0.0f)",
                  "const auto tu0 =", "auto v_a = tu0;", "v_c = __fadd_rn(v_c, 2.0f);",
                  f"{float(np.float32(math.pi))!r}f", "3.0f", "(-v_x)", "(true ? "):
        assert piece in cpp, piece
    assert "Every elem" not in cpp           # the docstring is dropped
    # a reassigned argument is assigned, not declared again
    assert "auto v_nx = " in cpp and "\n  v_nx = " in cpp


def _power(x, y, eps):
    return x ** y, y


def _chained(x, y, eps):
    return where(0.0 < x < 1.0, x, eps), y


def _branch(x, y, eps):
    if x > 0:
        return x, y
    return eps, y


def _loop(x, y, eps):
    for c in (1.0, 2.0):
        x = x + c * eps
    return x, y


def _ifexp(x, y, eps):
    return (x if y else eps), y


def _boolop(x, y, eps):
    return where((x > 0) and (y > 0), x, eps), y


def _modulo(x, y, eps):
    return x % 2.0, y


def _keyword(x, y, eps):
    return elem.minimum(x, b=eps), y


def _string(x, y, eps):
    return x, "y"


def _subscript(x, y, eps):
    return x, y[0]


def _three_values(x, y, eps):
    return x, y, eps


def _one_value(x, y, eps):
    return x


def _early_return(x, y, eps):
    return x, y
    x = x + 1.0  # noqa: F841


def _elem_unknown(x, y, eps):
    return elem.erf(x), y


def _elem_uncalled(x, y, eps):
    f = elem.exp
    return f(x), y


@pytest.mark.parametrize("fn,what", [
    (_power, "operator Pow"), (_chained, "chained"), (_branch, "statement If"),
    (_loop, "statement For"), (_ifexp, "expression IfExp"),
    (_boolop, "expression BoolOp"), (_modulo, "operator Mod"),
    (_keyword, "keyword arguments"), (_string, "not a number"),
    (_subscript, "expression Subscript"), (_three_values, "tuple of 2 values"),
    (_one_value, "tuple of 2 values"), (_early_return, "one return"),
    (_elem_unknown, "elem.erf"), (_elem_uncalled, "other than called")])
def test_constructs_outside_the_contract_raise_at_model_build(fn, what):
    with pytest.raises(ValueError, match=what):
        UserKernel(fn, 1)
    with pytest.raises(ValueError, match=what):
        attach_fused_scalar_kernels(linear_gaussian_ssm, fn)


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


def test_rendered_physics_compiles_and_agrees_on_the_host(tmp_path):
    """The LG, 2-D LG and arithmetic physics bit for bit against the plain
    version's torch arithmetic."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    cases = [(lg_step_elem, 1), (lg2d_step_elem, 2), (arithmetic_step_elem, 2)]
    src = _PRELUDE
    for i, (fn, D) in enumerate(cases):
        src += f"namespace m{i} {{\n{_outs(fn, D)}}}\n"
        ins = [f"x{d}[i]" for d in range(D)] + ["y"] + [f"e{d}[i]" for d in range(D)]
        outs = [f"o{k}[i]" for k in range(D + 1)]
        params = ", ".join([f"const float* x{d}" for d in range(D)] + ["float y"]
                           + [f"const float* e{d}" for d in range(D)]
                           + [f"float* o{k}" for k in range(D + 1)])
        src += (f'extern "C" void run_{i}({params}, int n) {{\n'
                f"  for (int i = 0; i < n; ++i) m{i}::step_elem({', '.join(ins + outs)});\n}}\n")
    (tmp_path / "s.cpp").write_text(src)
    lib_path = tmp_path / "libs.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", str(lib_path), str(tmp_path / "s.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(9)
    n = 20000
    p = ctypes.POINTER(ctypes.c_float)
    for i, (fn, D) in enumerate(cases):
        xs = [rng.normal(0, 2, n).astype(np.float32) for _ in range(D)]
        es = [rng.normal(0, 1, n).astype(np.float32) for _ in range(D)]
        y = np.float32(0.37)
        outs = [np.empty(n, np.float32) for _ in range(D + 1)]
        getattr(lib, f"run_{i}")(*(a.ctypes.data_as(p) for a in xs), ctypes.c_float(y),
                                 *(a.ctypes.data_as(p) for a in es),
                                 *(a.ctypes.data_as(p) for a in outs), ctypes.c_int(n))
        want = fn(*(torch.as_tensor(a) for a in xs), torch.tensor(y),
                  *(torch.as_tensor(a) for a in es))
        for got, w in zip(outs, want):
            np.testing.assert_array_equal(got, w.numpy())
