"""The roofline of the port's kernels on the card — counterpart of
``examples/roofline.py``.

    python -m cpprob_tpu_torch.util.roofline --out chiprun_out/roofline.json

It calibrates the card's achievable peaks with the micro-kernels of
``ops/calibrate.py`` (K17-K21: float32 FMA chains, tensor-core chains,
streaming ``x + 1`` at two sizes, Philox normals and uniforms, exp + log1p
chains), each timed with CUDA events over launches back to back after a
warm-up, and splits each kernel's work by resource (``bound`` and the
helpers below; the counts come from the kernel sources).  Each kernel then
has two bounds:

- ``bound_ms`` against the published peaks (3.35 TB/s; 67 TFLOP/s for the
  work outside the tensor cores, integer and float64 operations counted at
  that rate too; 989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor
  cores), and
- ``calibrated_bound_ms``, the largest of count / effective rate over its
  resources, with the resource (``calibrated_by``) and the kernel's
  fraction of it.  The effective rate of a resource is the larger of its
  calibration and the rate any measured kernel implies at its count
  (``examples/roofline.py:226-250``), so no fraction reads above 1; a
  kernel other than a calibration that sets one (``uncalibrated_setters``)
  has a wrong count or outran its calibration.

The JSON goes where ``--out`` says, never to ``ROOFLINE_r05.json`` (the
reference's TPU figures).  It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

__all__ = [
    "EXP_LOG_OPS", "F32_OPS_PER_S", "HBM_BYTES_PER_S", "PEAKS", "PHILOX_OPS",
    "RESOURCES", "TC_BF16_MACS_PER_S", "TC_TF32_MACS_PER_S", "analyze_kernels",
    "bound", "calibrate_peaks", "calibrated_rates", "calibration_work",
    "chain_chunk_bound", "chain_init_bound", "guided_net_ops",
    "guided_table_ops", "guided_tc_ops", "main",
    "normal_chunk_bound", "normal_init_bound", "peaks_from_runs", "time_ms", "uncalibrated_setters",
]

# H100 SXM datasheet peaks (dense): HBM, float32 outside the tensor cores,
# bf16 on the tensor cores (989 TFLOP/s = 494.5 T multiply-adds/s), TF32 on
# the tensor cores (495 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TC_BF16_MACS_PER_S = 989e12 / 2
TC_TF32_MACS_PER_S = 495e12 / 2
# operations of one Philox4x32-10 call: ten rounds of two 32x32->64
# multiplies (4 ops) and four xors, and the uniform's shift, convert and
# scale; of one Box-Muller pair (log, sqrt, sin and cos, 2 multiplies); of
# one exp + log1p pair
PHILOX_OPS = 83
BOX_MULLER_OPS = 8
EXP_LOG_OPS = 4

# the resources a kernel's work is split into, and the peak each is read
# against: bytes (HBM), float32 and 32-bit integer operations (the FMA and
# ALU pipes), float64 operations, tensor-core bf16 multiply-adds, Philox
# calls, Box-Muller pairs (each with its Philox call), exp + log1p pairs,
# tensor-core TF32 multiply-adds
RESOURCES = ("bytes", "f32_ops", "f64_ops", "tc_macs", "philox_calls",
             "normal_pairs", "exp_log_pairs", "tf32_macs")


def bound(n_bytes=0, f32_ops=0, *, f64_ops=0, tc_macs=0, philox_calls=0,
          normal_pairs=0, exp_log_pairs=0, tf32_macs=0, library_ms=None):
    """A kernel's work by resource (``counts``) and its bound against the
    published peaks: the larger of its bytes over the HBM rate and its
    operations over the rate of their type (float32, integer and float64
    operations, Philox calls at ``PHILOX_OPS``, Box-Muller pairs at
    ``BOX_MULLER_OPS``, exp/log pairs at ``EXP_LOG_OPS``, over 67 TFLOP/s;
    bf16 tensor-core multiply-adds over 494.5 T/s, TF32 ones over 247.5
    T/s).  ``library_ms``: the time of one PyTorch call for the same
    function, or None."""
    counts = {"bytes": n_bytes, "f32_ops": f32_ops, "f64_ops": f64_ops,
              "tc_macs": tc_macs, "philox_calls": philox_calls,
              "normal_pairs": normal_pairs, "exp_log_pairs": exp_log_pairs,
              "tf32_macs": tf32_macs}
    counts = {k: float(v) for k, v in counts.items() if v}
    ops = (f32_ops + f64_ops + PHILOX_OPS * philox_calls
           + BOX_MULLER_OPS * normal_pairs + EXP_LOG_OPS * exp_log_pairs)
    ms_b = n_bytes / HBM_BYTES_PER_S * 1e3
    ms_o = max(ops / F32_OPS_PER_S, tc_macs / TC_BF16_MACS_PER_S,
               tf32_macs / TC_TF32_MACS_PER_S) * 1e3
    return {"bound_ms": max(ms_b, ms_o),
            "bound_by": "bytes" if ms_b >= ms_o else "operations",
            "library_ms": library_ms, "counts": counts}


def chain_chunk_bound(n, K, steps, checks=0):
    """The K-state chunk kernels (K2, K4, K5, K8): 16 B per particle (state
    and weight in and out); per particle-step a quarter of a Philox call
    (a uniform is one of the call's four words), the inverse-CDF walk
    (2(K-1)) and the weight update (K); per particle and island check an exp
    and K + 3 sums.  A bound is the least time the card could take for
    the same work, so it counts what these inputs need (four uniforms from
    a call), not what a design spends (a kernel may throw words away)."""
    return bound(16 * n + 4 * steps, n * steps * (3 * K - 2) + n * checks * (K + 4),
                 philox_calls=n * steps / 4)


def chain_init_bound(n, K):
    """The init kernels (K1, K9): 8 B written per particle; a quarter of a
    Philox call (one uniform), the inverse-CDF walk, the emission pick and
    the record's sums; counted as :func:`chain_chunk_bound` counts."""
    return bound(8 * n, n * (4 * K + 1), philox_calls=n / 4)


def normal_chunk_bound(n, steps, D=1, physics_ops=6):
    """The chunk kernels with Box-Muller draws (K6, K7, K10, K11): 8 (D + 1)
    B per particle; per particle-step and plane half a Box-Muller pair (and
    its Philox call), and the physics."""
    pairs = n * steps * D / 2
    return bound(8 * (D + 1) * n, n * steps * physics_ops,
                 philox_calls=pairs, normal_pairs=pairs)


def normal_init_bound(n, physics_ops=6):
    """The Box-Muller start (``lg_init_kernel``): 8 B written per particle;
    half a Box-Muller pair (and its Philox call) and the physics, counted as
    :func:`normal_chunk_bound` counts a step."""
    return bound(8 * n, n * physics_ops, philox_calls=n / 2, normal_pairs=n / 2)


def guided_net_ops(sizes):
    """Float operations of one evaluation of a guided proposal net of
    ``sizes`` per particle, as the kernels form it: the first layer's
    per-particle input through a multiply, an add and a max per unit (its
    step scalars and its one-hot rows are formed once per step), then a
    multiply and an add per weight of the later layers, a max per later
    hidden unit."""
    ops = 3 * sizes[1]
    ops += sum(2 * a * b for a, b in zip(sizes[1:-1], sizes[2:]))
    return ops + sum(sizes[2:-1])


def guided_tc_ops(sizes):
    """K12's tensor-core twin (``ops/guided_tc.py``) per particle-step, for
    a net of ``sizes`` (hidden widths padded to multiples of 8, as run):
    ``tf32_macs``, three TF32 multiply-adds (3xTF32, the fewest that give
    float32-level products on the tensor cores) per weight of the
    hidden->hidden layers; ``f32_ops``, the first layer (a multiply-add and
    a max per unit), a max per later hidden unit (the bias is the first
    product's addend), the output layer (a multiply-add per weight, 2 ops)
    and the tail's 14 (move 2, log q 4, densities and weight 8, as K12's
    bound counts them).  The TF32 split of each activation (3 operations)
    and the quad's adds of the output layer are work of the kernel's
    design, not of the function, and are not counted."""
    ps = [sizes[0], *(-(-h // 8) * 8 for h in sizes[1:-1]), sizes[-1]]
    hidden = ps[1:-1]
    macs = sum(a * b for a, b in zip(hidden[:-1], hidden[1:]))
    f32 = 3 * hidden[0] + sum(hidden[1:]) + 4 * hidden[-1] + 14
    return {"tf32_macs": 3 * macs, "f32_ops": f32}


def guided_table_ops(sizes, K):
    """Operations of K13's tables per CTA and step: the net for each of
    the K source states (the one-hot layer an add per unit), and per
    (a, b) entry the max, the exp-sums and the RN entry (2K + 8)."""
    return K * guided_net_ops(sizes) + 5 * sizes[1] + K * K * (2 * K + 8)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls back to back after
    one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# calibration

# each calibration's kernel line: name, TPU kernel
CALIBRATIONS = {
    "fp32": ("fp32_chain_kernel (K17)", "examples/roofline.py:60"),
    "tensor_cores": ("tensor_core_kernel (K18, wgmma m64n64k16 bf16)",
                     "examples/roofline.py:86"),
    "hbm": ("add_one_kernel (K19, 512 MB moved)", "examples/roofline.py:125"),
    "normals": ("normal_rate_kernel (K20a, Box-Muller pairs)",
                "examples/roofline.py:151"),
    "philox": ("philox_rate_kernel (K20b, one uniform per Philox call)",
               "examples/roofline.py:151"),
    "transcendental": ("transcendental_kernel (K21, exp + log1p)",
                       "examples/roofline.py:182"),
}
CALIBRATE_SOURCE = "cpprob_tpu_torch/ops/csrc/calibrate.cu"


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline measures the card: no CUDA device")


def calibrate_peaks(seed: int = 0, reps: int = 8):
    """Runs and times K17-K21 at the reference's sizes on the card.
    Returns ``(peaks, runs)``: the achievable rates (``peaks``, with the
    card's name and power limit, the fixed cost of a launch from the HBM
    fit, and cuBLAS's bf16 rate at 8192^3 for comparison), and per
    calibration its time (``ms``), its inputs (``inputs``, for comparisons)
    and its work (``bound``'s fields)."""
    from ..ops import calibrate as cal
    from .profiling import gpu_name_and_power

    _require_cuda()
    dev = torch.device("cuda")
    work = calibration_work()
    runs = {}

    x = torch.ones(cal.FP32_N, device=dev)
    ms = time_ms(lambda: cal.calibrate_fp32(x), reps)
    runs["fp32"] = {"ms": ms, "inputs": (x,), **work["fp32"]}

    a_np, b_np = cal.tensor_core_operands(cal.TC_ROWS, seed)
    a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
    ms = time_ms(lambda: cal.calibrate_tensor_cores(a, b), reps)
    # one PyTorch call with the same multiply-adds, (4096, 8192) @ (8192,
    # 4096) in bf16 (2^37 at the default sizes); and cuBLAS at 8192^3
    la = torch.randn(4096, 8192, device=dev, dtype=torch.bfloat16)
    lb = torch.randn(8192, 4096, device=dev, dtype=torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(la, lb), reps)
    lc = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    cublas_ms = time_ms(lambda: torch.matmul(lc, lc), reps)
    del la, lb, lc
    runs["tensor_cores"] = {"ms": ms, "inputs": (a, b), **work["tensor_cores"],
                            "library_ms": lib_ms}

    hbm = []
    for n in cal.HBM_SIZES:
        xh = torch.zeros(n, device=dev)
        t = time_ms(lambda: cal.calibrate_hbm(xh), 2 * reps)
        lib = time_ms(lambda: torch.add(xh, 1.0), 2 * reps)
        hbm.append((t * 1e-3, 8 * n, lib, xh))
    (t1, b1, _, _), (t2, b2, lib_ms, xh) = hbm
    bw = (b2 - b1) / (t2 - t1)
    runs["hbm"] = {"ms": t2 * 1e3, "ms_small": t1 * 1e3, "inputs": (xh,),
                   **work["hbm"], "library_ms": lib_ms}

    xp = torch.zeros(cal.PRNG_N, device=dev)
    ms = time_ms(lambda: cal.calibrate_normals(seed, xp, cal.PRNG_DRAWS // 2), reps)
    runs["normals"] = {"ms": ms, "inputs": (xp,), **work["normals"]}
    ms = time_ms(lambda: cal.calibrate_philox(seed, xp, cal.PRNG_DRAWS), reps)
    runs["philox"] = {"ms": ms, "inputs": (xp,), **work["philox"]}

    xt = torch.ones(cal.TRANS_N, device=dev)
    ms = time_ms(lambda: cal.calibrate_transcendental(xt), reps)
    runs["transcendental"] = {"ms": ms, "inputs": (xt,), **work["transcendental"]}

    peaks = {**peaks_from_runs(runs),
             "hbm_marginal_bytes_per_s": bw,
             "launch_fixed_s": max(t1 - b1 / bw, 0.0),
             "cublas_bf16_8192_macs_per_s": 8192 ** 3 / (cublas_ms * 1e-3),
             "card": gpu_name_and_power()}
    return peaks, runs


def calibration_work():
    """Each calibration's work by resource at the reference's sizes
    (``bound``'s result, by key of ``CALIBRATIONS``; K19 at its larger
    size).  A calibration's peak is the count of its resource over its time
    (``PEAKS``), so the count is stated here once."""
    from ..ops import calibrate as cal

    pairs = cal.PRNG_DRAWS // 2
    n_hbm = cal.HBM_SIZES[-1]
    return {
        # the chains' multiply-adds, as the reference's rate counts them
        # (examples/roofline.py:83); the 15 operations an element that start
        # and sum the chains are not counted
        "fp32": bound(8 * cal.FP32_N, cal.FP32_N * cal.FP32_STEPS * 8 * 2),
        "tensor_cores": bound(
            4 * (2 * cal.TC_ROWS * cal.TC_DIM + cal.TC_DIM ** 2),
            cal.TC_ROWS * cal.TC_DIM * cal.TC_CHAINS * (cal.TC_REPS + 1),
            tc_macs=cal.TC_ROWS * cal.TC_DIM ** 2 * cal.TC_CHAINS * cal.TC_REPS),
        "hbm": bound(8 * n_hbm, n_hbm),
        "normals": bound(8 * cal.PRNG_N, cal.PRNG_N * (2 * pairs + 1),
                         philox_calls=cal.PRNG_N * pairs,
                         normal_pairs=cal.PRNG_N * pairs),
        "philox": bound(8 * cal.PRNG_N, cal.PRNG_N * (cal.PRNG_DRAWS + 1),
                        philox_calls=cal.PRNG_N * cal.PRNG_DRAWS),
        "transcendental": bound(8 * cal.TRANS_N, 2 * cal.TRANS_N * cal.TRANS_CHAIN,
                                exp_log_pairs=cal.TRANS_N * cal.TRANS_CHAIN),
    }


# each rate peak: (its calibration, the resource counted, units per count)
PEAKS = {
    "fp32_flops_per_s": ("fp32", "f32_ops", 1),
    "tensor_core_bf16_macs_per_s": ("tensor_cores", "tc_macs", 1),
    "philox_calls_per_s": ("philox", "philox_calls", 1),
    "normal_variates_per_s": ("normals", "normal_pairs", 2),
    "exp_log1p_pairs_per_s": ("transcendental", "exp_log_pairs", 1),
}


def peaks_from_runs(runs):
    """The rate peaks of ``PEAKS`` from the calibrations' counts and times
    (``runs[key]``: ``counts`` and ``ms``)."""
    return {peak: per * runs[key]["counts"][r] / (runs[key]["ms"] * 1e-3)
            for peak, (key, r, per) in PEAKS.items()}


def calibrated_rates(peaks):
    """The rate each resource is read against: the calibrations, float64 at
    half the float32 rate and TF32 multiply-adds at half the bf16 rate (the
    H100's ratios; neither is calibrated), a Box-Muller pair at half the
    normal rate."""
    return {
        "bytes": peaks["hbm_marginal_bytes_per_s"],
        "f32_ops": peaks["fp32_flops_per_s"],
        "f64_ops": peaks["fp32_flops_per_s"] / 2,
        "tc_macs": peaks["tensor_core_bf16_macs_per_s"],
        "philox_calls": peaks["philox_calls_per_s"],
        "normal_pairs": peaks["normal_variates_per_s"] / 2,
        "exp_log_pairs": peaks["exp_log1p_pairs_per_s"],
        "tf32_macs": peaks["tensor_core_bf16_macs_per_s"] / 2,
    }


def analyze_kernels(peaks, kernels):
    """Adds ``calibrated_bound_ms``, ``calibrated_by`` and
    ``calibrated_fraction`` to each kernel entry (``counts`` and a measured
    ``ms``).  Each resource's effective rate is the larger of its
    calibration and the best rate a measured kernel implies at its count.
    Returns ``{"calibrated": rates, "effective": rates, "set_by": the
    kernel that set each effective rate}``."""
    rates = calibrated_rates(peaks)
    eff, set_by = dict(rates), {r: "calibration" for r in rates}
    for k in kernels:
        for r, c in k["counts"].items():
            implied = c / (k["ms"] * 1e-3)
            if implied > eff[r]:
                eff[r], set_by[r] = implied, k["name"]
    for k in kernels:
        times = {r: c / eff[r] * 1e3 for r, c in k["counts"].items()}
        by = max(times, key=times.get)
        k["calibrated_bound_ms"] = times[by]
        k["calibrated_by"] = by
        k["calibrated_fraction"] = times[by] / k["ms"]
    return {"calibrated": rates, "effective": eff, "set_by": set_by}


def uncalibrated_setters(rates):
    """The effective rates (of ``analyze_kernels``) that a kernel other
    than a calibration set, by resource: its count is wrong, or the
    calibration falls short of the card's peak."""
    own = {"calibration", *(name for name, _ in CALIBRATIONS.values())}
    return {r: by for r, by in rates["set_by"].items() if by not in own}


def calibration_entries(runs, launches=None):
    """The kernel entries of the calibrations (the ``kernels`` line's
    fields but the comparison's ``max_abs_err`` and ``plain_ms``)."""
    out = []
    for key, (name, replaces) in CALIBRATIONS.items():
        r = runs[key]
        out.append({"name": name, "route": "cuda", "source": CALIBRATE_SOURCE,
                    "replaces": replaces,
                    "launches": None if launches is None else launches[key],
                    "ms": r["ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "counts": r["counts"]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="where to write the JSON (default: standard output only)")
    args = ap.parse_args(argv)
    _require_cuda()
    from .profiling import env_versions

    peaks, runs = calibrate_peaks()
    kernels = calibration_entries(runs)
    rates = analyze_kernels(peaks, kernels)
    out = {"artifact": "the card's calibrated peaks (K17-K21) and their "
                       "kernels' bounds",
           "versions": env_versions(), "peaks": peaks, "rates": rates,
           "datasheet": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                         "f32_ops_per_s": F32_OPS_PER_S,
                         "tensor_core_bf16_macs_per_s": TC_BF16_MACS_PER_S},
           "kernels": kernels}
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return out


if __name__ == "__main__":
    main()
