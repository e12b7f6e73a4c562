"""The port's calibration kernels (``cpprob_tpu_torch.ops.calibrate``, K17-K21)
and its roofline (``cpprob_tpu_torch.util.roofline``) against the reference's
``examples/roofline.py``.

The reference's ``calibrate_*`` functions call ``pl.pallas_call`` without
``interpret``; the ``reference`` fixture wraps it with ``interpret=True``,
captures the callable and stubs the timer, so each reference kernel body runs
on the CPU on the test's own inputs.  On the CPU the port's wrappers run
their plain versions.  K20 draws from the TPU's hardware generator, which has
no CPU lowering: its plain versions are held bit for bit to
``ops/philox.py`` and ``fused_lg._normal_pair``, and in distribution.
"""

import importlib.util
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu_torch.ops import calibrate as cal
from cpprob_tpu_torch.ops.fused_lg import _normal_pair
from cpprob_tpu_torch.ops.philox import philox_uniform
from cpprob_tpu_torch.util import roofline as rl

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def reference(monkeypatch):
    """``examples/roofline.py`` with ``pl.pallas_call`` run in interpret
    mode; returns (module, list of the captured pallas callables)."""
    spec = importlib.util.spec_from_file_location(
        "reference_roofline", os.path.join(ROOT, "examples", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    captured = []
    orig = mod.pl.pallas_call

    def pallas_call(*args, **kwargs):
        f = orig(*args, interpret=True, **kwargs)
        captured.append(f)
        return f

    monkeypatch.setattr(mod.pl, "pallas_call", pallas_call)
    ticks = itertools.count(1)
    monkeypatch.setattr(mod, "_timeit", lambda g, *a, **k: float(next(ticks)))
    return mod, captured


def test_fp32_chains_match_reference(reference):
    mod, captured = reference
    mod.calibrate_vpu(rows=16, block_r=8)          # chain 2048 = 8 x 256
    x = np.random.default_rng(0).uniform(0.5, 2.0, (16, 128)).astype(np.float32)
    ref = np.asarray(captured[-1](jnp.asarray(x))).ravel()
    xt = torch.as_tensor(x.ravel())
    got = cal.calibrate_fp32(xt).numpy()
    assert cal.FP32_STEPS == 2048 // 8
    assert torch.equal(torch.as_tensor(got), cal.calibrate_fp32_plain(xt))
    # the port fuses each multiply-add (one rounding), the reference rounds
    # twice: 256 steps apart by at most a few float32 ulps
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_fp32_plain_rounds_each_step_once():
    """One step of the plain version against an exact rational check: the
    float32 nearest to v * c + b."""
    from fractions import Fraction

    def round_f32(q):
        """The float32 nearest to the rational q, ties to even."""
        f = np.float32(float(q))
        cands = [f, np.nextafter(f, np.float32(np.inf)),
                 np.nextafter(f, np.float32(-np.inf))]
        return min(cands, key=lambda y: (abs(Fraction(float(y)) - q),
                                         int(y.view(np.int32)) & 1))

    v = np.random.default_rng(1).uniform(-40.0, 40.0, 256).astype(np.float32)
    got = cal.calibrate_fp32_plain(torch.as_tensor(v), steps=1).numpy()
    c, b = Fraction(float(np.float32(1.0000001))), Fraction(float(np.float32(1e-7)))
    for i, s in enumerate(cal._chain_scales(8)):
        w = (torch.as_tensor(v) * s).numpy()
        exact = [round_f32(Fraction(float(x)) * c + b) for x in w]
        if i == 0:
            want = np.array(exact, np.float32)
        else:
            want = (want + np.array(exact, np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_tensor_core_chains_match_reference(reference):
    mod, captured = reference
    reps = 4
    mod.calibrate_mxu(m=16, k=cal.TC_DIM, n=cal.TC_DIM, par=cal.TC_CHAINS, reps=reps)
    a, b = cal.tensor_core_operands(16, seed=3)
    ref = np.asarray(captured[-1](jnp.asarray(a), jnp.asarray(b)))
    got = cal.calibrate_tensor_cores(torch.as_tensor(a), torch.as_tensor(b),
                                     reps=reps).numpy()
    # the reference's dot runs in float32 in interpret mode, the port's
    # operands are rounded to bf16 (2^-8 relative) before each product
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < reps * 2.0 ** -8, rel
    # 1000 Q with Q orthogonal keeps each row's norm through `* 1e-3`
    np.testing.assert_allclose(np.linalg.norm(got, axis=1),
                               cal.TC_CHAINS * np.linalg.norm(a, axis=1),
                               rtol=reps * 2.0 ** -7)


def test_hbm_stream_matches_reference(reference):
    mod, captured = reference
    mod.calibrate_hbm(block_r=1 << 14)
    assert len(captured) == 2                # 128 MB and 512 MB moved
    x = np.random.default_rng(2).normal(size=(1 << 17, 128)).astype(np.float32)
    ref = np.asarray(captured[0](jnp.asarray(x))).ravel()
    got = cal.calibrate_hbm(torch.as_tensor(x.ravel())).numpy()
    np.testing.assert_array_equal(got, ref)
    assert [8 * n for n in cal.HBM_SIZES] == [128 << 20, 512 << 20]


def test_transcendental_chain_matches_reference(reference):
    mod, captured = reference
    chain = 128     # tracing 1024 unrolled steps takes ~25 s on a CPU
    mod.calibrate_transcendental(rows=16, block_r=8, chain=chain)
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (16, 128)).astype(np.float32)
    ref = np.asarray(captured[-1](jnp.asarray(x))).ravel()
    got = cal.calibrate_transcendental(torch.as_tensor(x.ravel()), chain).numpy()
    # a contracting map (|slope| < 1/2): last-bit differences of exp and
    # log1p between numpy-XLA and torch do not grow
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stream", [0, 3])
def test_normal_rate_plain_is_the_lg_pairs(stream):
    n, pairs, seed = 512, 6, 11
    x = torch.as_tensor(np.random.default_rng(5).normal(size=n).astype(np.float32))
    got = cal.calibrate_normals(seed, x, pairs, stream)
    g = torch.arange(n)
    acc = x.clone()
    for p in range(pairs):
        rc, rs = _normal_pair(seed, g, p, stream)
        acc = acc + rc
        acc = acc + rs
    assert torch.equal(got, acc * 1e-9)


@pytest.mark.parametrize("stream", [0, 3])
def test_philox_rate_plain_is_philox_uniforms(stream):
    n, calls, seed = 512, 7, 12
    x = torch.zeros(n)
    got = cal.calibrate_philox(seed, x, calls, stream)
    acc = x.clone()
    for c in range(calls):
        acc = acc + philox_uniform(seed, torch.arange(n), c, stream)
    assert torch.equal(got, acc * 1e-9)


def test_prng_sums_have_their_distribution():
    """The sum of 512 normals per element: mean 0, variance 512; of 512
    uniforms: mean 256, variance 512 / 12 (5 standard errors)."""
    n, draws = 4096, cal.PRNG_DRAWS
    z = cal.calibrate_normals(7, torch.zeros(n), draws // 2).double() * 1e9
    u = cal.calibrate_philox(7, torch.zeros(n), draws).double() * 1e9
    for s, mean, var in ((z, 0.0, draws), (u, draws / 2, draws / 12)):
        assert abs(float(s.mean()) - mean) < 5 * np.sqrt(var / n)
        assert abs(float(s.var()) - var) < 5 * var * np.sqrt(2 / n)


def test_wrappers_validate():
    with pytest.raises(ValueError, match="at least 1"):
        cal.calibrate_fp32(torch.ones(4), steps=0)
    with pytest.raises(ValueError, match="at least 1"):
        cal.calibrate_transcendental(torch.ones(4), chain=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cal._launch("k", "fp32", torch.ones(4, device="meta"), None)


# ---------------------------------------------------------------------------
# the roofline


def _peaks(**over):
    peaks = {"fp32_flops_per_s": 50e12, "tensor_core_bf16_macs_per_s": 300e12,
             "hbm_marginal_bytes_per_s": 3e12, "philox_calls_per_s": 1e12,
             "normal_variates_per_s": 1e12, "exp_log1p_pairs_per_s": 2e12}
    peaks.update(over)
    return peaks


def test_published_bounds_keep_their_counts():
    """The helpers' published bounds are those of the counts before they
    were split by resource (83 operations a Philox call; the chain kernels'
    uniforms at a quarter of a call each, one of its four words)."""
    n = 1 << 26
    old = max(16 * n / 3.35e12, n * 15 * (83 / 4 + 7) / 67e12 + n * 7 / 67e12)
    assert rl.chain_chunk_bound(n, 3, 15, checks=1)["bound_ms"] == pytest.approx(old * 1e3)
    assert rl.chain_chunk_bound(n, 3, 15)["counts"]["philox_calls"] == n * 15 / 4
    n = 1 << 24
    assert rl.normal_chunk_bound(n, 8)["bound_ms"] == pytest.approx(
        n * 8 * (83 / 2 + 4 + 6) / 67e12 * 1e3)
    assert rl.chain_init_bound(n, 5)["bound_ms"] == pytest.approx(
        max(8 * n / 3.35e12, n * (83 / 4 + 21) / 67e12) * 1e3)
    b = rl.bound(8, 0, tc_macs=494.5e12)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1e3)
    assert b["counts"] == {"bytes": 8.0, "tc_macs": 494.5e12}


def test_analyze_kernels_binding_resource_and_effective_peak():
    kernels = [
        # Philox-bound at the calibration: 1e9 calls at 1e12/s = 1 ms
        {"name": "chain", "ms": 2.0, **rl.bound(1e6, 1e9, philox_calls=1e9)},
        # bytes-bound: 3e9 B at 3e12 B/s = 1 ms
        {"name": "stream", "ms": 1.25, **rl.bound(3e9, 1e6)},
        # faster than the calibrated HBM rate implies: raises the peak
        {"name": "fast", "ms": 0.5, **rl.bound(2e9, 1e3)},
    ]
    rates = rl.analyze_kernels(_peaks(), kernels)
    by = {k["name"]: k for k in kernels}
    assert by["chain"]["calibrated_by"] == "philox_calls"
    assert by["chain"]["calibrated_bound_ms"] == pytest.approx(1.0)
    assert by["chain"]["calibrated_fraction"] == pytest.approx(0.5)
    assert rates["effective"]["bytes"] == pytest.approx(4e12)
    assert rates["set_by"]["bytes"] == "fast"
    assert rates["calibrated"]["f64_ops"] == 25e12
    assert by["fast"]["calibrated_fraction"] == pytest.approx(1.0)
    assert by["stream"]["calibrated_bound_ms"] == pytest.approx(0.75)
    assert all(k["calibrated_fraction"] <= 1.0 + 1e-12 for k in kernels)
    # a kernel other than a calibration that sets a rate is named
    assert rl.uncalibrated_setters(rates) == {"bytes": "fast"}


def test_each_calibration_defines_its_own_peak():
    """A rate peak is its calibration's count over its time, so against the
    peaks each calibration reads a fraction of 1 on its resource and sets no
    effective rate (K17 counts the chains' multiply-adds in both)."""
    ms = {"fp32": 0.3252, "tensor_cores": 0.5428, "hbm": 0.1945,
          "normals": 2.7504, "philox": 2.1495, "transcendental": 2.3429}
    work = rl.calibration_work()
    assert work["fp32"]["counts"]["f32_ops"] == cal.FP32_N * 2048 * 2
    runs = {key: {"ms": ms[key], **w} for key, w in work.items()}
    peaks = {**rl.peaks_from_runs(runs), "hbm_marginal_bytes_per_s": 2.9e12}
    assert set(peaks) == set(rl.PEAKS) | {"hbm_marginal_bytes_per_s"}
    entries = rl.calibration_entries(runs)
    rates = rl.analyze_kernels(peaks, entries)
    assert set(rates["set_by"].values()) == {"calibration"}
    assert rl.uncalibrated_setters(rates) == {}
    binding = {"fp32": "f32_ops", "tensor_cores": "tc_macs", "normals": "normal_pairs",
               "philox": "philox_calls", "transcendental": "exp_log_pairs"}
    for e, key in zip(entries, rl.CALIBRATIONS):
        if key in binding:
            assert e["calibrated_by"] == binding[key]
            assert e["calibrated_fraction"] == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_no_fraction_above_one(seed):
    """Random counts and times: the effective-peak rule keeps every
    calibrated bound at or under the kernel's own time."""
    rng = np.random.default_rng(seed)
    kernels = []
    for i in range(12):
        kw = {r: float(rng.uniform(1e6, 1e11)) for r in rl.RESOURCES[2:]
              if rng.random() < 0.5}
        kernels.append({"name": f"k{i}", "ms": float(rng.uniform(0.01, 5.0)),
                        **rl.bound(float(rng.uniform(1e6, 1e10)),
                                   float(rng.uniform(1e6, 1e12)), **kw)})
    rl.analyze_kernels(_peaks(), kernels)
    for k in kernels:
        assert 0.0 < k["calibrated_fraction"] <= 1.0 + 1e-12
        assert k["calibrated_by"] in k["counts"]


def test_calibration_entries_carry_the_kernels_line_fields():
    runs = {key: {"ms": 1.0, **rl.bound(8, 16)} for key in rl.CALIBRATIONS}
    entries = rl.calibration_entries(runs, {key: 3 for key in rl.CALIBRATIONS})
    assert len(entries) == 6 and all(e["launches"] == 3 for e in entries)
    for e in entries:
        assert {"name", "route", "source", "replaces", "ms", "bound_ms",
                "bound_by", "library_ms", "counts"} <= set(e)
        assert e["replaces"].startswith("examples/roofline.py:")


def test_entry_point_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "roofline.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.main(["--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.calibrate_peaks()
    assert not out.exists()


@pytest.mark.cuda
def test_calibration_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.0, 1 << 16)
                        .astype(np.float32), device=dev)
    assert torch.equal(cal.calibrate_fp32(x), cal.calibrate_fp32_plain(x))
    assert torch.equal(cal.calibrate_hbm(x), cal.calibrate_hbm_plain(x))
    torch.testing.assert_close(cal.calibrate_transcendental(x),
                               cal.calibrate_transcendental_plain(x), rtol=0, atol=1e-6)
    torch.testing.assert_close(cal.calibrate_normals(1, x, 8),
                               cal.calibrate_normals_plain(1, x, 8), rtol=0, atol=1e-13)
    assert torch.equal(cal.calibrate_philox(1, x, 8), cal.calibrate_philox_plain(1, x, 8))
    a, b = (torch.as_tensor(t, device=dev) for t in cal.tensor_core_operands(256))
    k = cal.calibrate_tensor_cores(a, b, reps=4)
    p = cal.calibrate_tensor_cores_plain(a, b, reps=4)
    assert float((k - p).norm() / p.norm()) < 4 * 2.0 ** -8


def test_sass_comparison_parses_cuobjdump_and_ptxas():
    from cpprob_tpu_torch.util import sass

    dump = """
\tcode for sm_90a
\t\tFunction : _Z6kernelPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                        /* 0x000000000000794d */
\t\tFunction : _ZN44_GLOBAL__N__8a8d265c_11_a_cu_5otherEv
        /*0000*/                   BRA  0x10;                    /* 0xfffffffc00fc7947 */
"""
    # the anonymous namespace's path hash is dropped from the names
    assert sass.parse_sass(dump) == {"_Z6kernelPf": ["LDC R1, c[0x0][0x28]", "EXIT"],
                                     "_ZN44_GLOBAL__N__11_a_cu_5otherEv": ["BRA 0x10"]}
    log = ("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z6kernelPf\n"
           "ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem\n"
           "ptxas info    : Compiling entry function "
           "'_ZN44_GLOBAL__N__ab182f26_11_a_cu_5otherEv' for 'sm_90a'\n"
           "ptxas info    : Used 8 registers\n")
    assert sass.parse_registers(log) == {"_Z6kernelPf": 40,
                                         "_ZN44_GLOBAL__N__11_a_cu_5otherEv": 8}


def test_sass_report_parses_spills():
    """``util/sass.py`` reads each function's spill bytes from ptxas -v (the
    registers as before), as ``chip_smoke.py``'s SASS check prints them."""
    from cpprob_tpu_torch.util import sass

    log = ("ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kPf\n"
           "    16 bytes stack frame, 80 bytes spill stores, 72 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n"
           "ptxas info    : Function properties for "
           "_ZN44_GLOBAL__N__ab182f26_11_a_cu_5otherEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    assert sass.parse_spills(log) == {"_Z1kPf": (80, 72),
                                      "_ZN44_GLOBAL__N__11_a_cu_5otherEv": (0, 0)}
    assert sass.parse_registers(log) == {"_Z1kPf": 64}


def test_build_log_is_kept_beside_the_library(tmp_path, monkeypatch):
    """``ops/_build.py`` keeps the compiler's output beside the library it
    builds, so a process that finds the library built (a second script in
    the same checkout) still reads the ptxas report that the SASS checks
    need.  nvcc is replaced by a stub that writes the library."""
    import subprocess

    from cpprob_tpu_torch.ops import _build

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "ptxas info    : Used 40 registers\n", "")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    src, lib = tmp_path / "k.cu", tmp_path / "libk-0.so"
    src.write_text("// a kernel")
    _build._build("k", src, lib, [])
    assert lib.exists() and _build.BUILD_LOGS["k"].startswith("ptxas info")
    _build.BUILD_LOGS.clear()
    _build._build("k", src, lib, [])
    assert len(calls) == 1
    assert _build.BUILD_LOGS["k"] == "ptxas info    : Used 40 registers\n"


def test_sass_report_parses_stack_frames():
    """``util/sass.py`` reads each function's stack frame (local memory
    besides spills) from ptxas -v, as ``chip_smoke.py`` holds the chain
    kernels to none."""
    from cpprob_tpu_torch.util import sass

    log = ("ptxas info    : Function properties for _Z1kPf\n"
           "    16 bytes stack frame, 80 bytes spill stores, 72 bytes spill loads\n"
           "ptxas info    : Function properties for "
           "_ZN44_GLOBAL__N__ab182f26_11_a_cu_5otherEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    assert sass.parse_stack(log) == {"_Z1kPf": 16,
                                     "_ZN44_GLOBAL__N__11_a_cu_5otherEv": 0}


def test_sass_loops_are_counted_from_label_to_backward_branch():
    """``util/sass.py`` counts each loop's instructions (a backward branch
    to a label), as ``util/user_parts.py`` reads a kernel's step loop."""
    from cpprob_tpu_torch.util import sass

    dump = (
        "        Function : _Z1kPf\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        ".L_x_0:\n"
        "        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;\n"
        ".L_x_1:\n"
        "        /*0020*/                   FADD R3, R3, R2 ;\n"
        "        /*0030*/              @P0 BRA `(.L_x_1) ;\n"
        "        /*0040*/                   ISETP.GE.AND P1, PT, R2, 0x8, PT ;\n"
        "        /*0050*/             @!P1 BRA `(.L_x_0) ;\n"
        "        /*0060*/                   BRA `(.L_x_2) ;\n"
        ".L_x_2:\n"
        "        /*0070*/                   EXIT ;\n"
        "        Function : _Z1gv\n"
        "        /*0000*/                   EXIT ;\n")
    assert sass.parse_loops(dump) == {"_Z1kPf": [5, 2], "_Z1gv": []}
    assert len(sass.parse_sass(dump)["_Z1kPf"]) == 8


def test_sass_loop_opcodes_are_counted_per_loop():
    """``parse_loop_opcodes`` counts each loop's opcodes, as
    ``chip_smoke.py`` reads K14's float64 instructions a weight from its
    batch loop."""
    from cpprob_tpu_torch.util import sass

    dump = (
        "        Function : _Z1kPf\n"
        "        /*0000*/                   DADD R4, R4, R6 ;\n"
        ".L_x_0:\n"
        "        /*0010*/                   DFMA R2, R2, R4, R6 ;\n"
        "        /*0020*/              @P0 DADD R2, R2, R8 ;\n"
        "        /*0030*/                   DFMA R2, R2, R4, R6 ;\n"
        "        /*0040*/             @!P1 BRA `(.L_x_0) ;\n"
        "        /*0050*/                   EXIT ;\n")
    assert sass.parse_loop_opcodes(dump) == {
        "_Z1kPf": [(4, {"DFMA": 2, "DADD": 1, "BRA": 1})]}
    assert sass.parse_loops(dump) == {"_Z1kPf": [4]}
