"""K12's two twins at the trainer's width, ``[3,64,64,2]`` (and
``[3,48,48,2]``), held to the independent plain reference of the
benchmark's ``guided_lg`` configuration (``benchmarks/reference/
guided_lg.py``, loaded by path: float64, its own Philox4x32-10 and
Box-Muller, nothing of the port):

- the tensor-core twin's packed replay (``tc_net_plain``, the kernel's
  3xTF32 arithmetic from the packed buffer) and K12's plain version agree
  with the reference's net and guided step; the 1xTF32 replay does not;
- the reference's draws are the port's for the same counters;
- the committed net (``benchmarks/configs/guided_lg_net.json``) lies near
  the model's optimal proposal N((z + y) / 2, 1/2);
- on a card (``cuda``-marked), both kernels against the reference per
  particle over a chunk of 8 steps.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from cpprob_tpu_torch.interop import mlp_params_from_numpy
from cpprob_tpu_torch.models.linear_gaussian import (
    linear_gaussian_ssm,
    obs_logpdf_elem,
    trans_logpdf_elem,
)
from cpprob_tpu_torch.ops.fused_lg import normal_steps
from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_scalar_kernels
from cpprob_tpu_torch.ops.guided_scalar import GuidedScalarKernel, _net_plain, guided_scalar_chunk_plain
from cpprob_tpu_torch.ops.guided_tc import GuidedTensorCoreKernel, pack_weights, tc_net_plain
from cpprob_tpu_torch.ops.philox import philox4x32, split_seed

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
_spec = importlib.util.spec_from_file_location("guided_lg_reference",
                                               BENCH / "reference" / "guided_lg.py")
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)
CFG = json.loads((BENCH / "configs" / "guided_lg.json").read_text())
NET = json.loads((BENCH / "configs" / "guided_lg_net.json").read_text())
T = CFG["series_length"]

# (mean, raw) against the float64 net, relative to the magnitude of the
# terms each output sums (the net run on |W|, |b| and |activations|):
# float32-level products and sums; over these nets the replay and K12's
# plain version read up to 3.6e-8, the 1xTF32 replay (products of TF32
# parts alone, 2^-11 a product) 2.6e-5 to 4.5e-5, so the tolerance sits
# 28x above the one and 26x below the other
NET_TOL = 1e-6
# one guided step against the reference's, states and log-weights within
# STEP_TOL of 1 + |reference| (the net's rounding carried through the move
# and the float32 tail): read up to 1.2e-6, 1xTF32 5.8e-4 to 2.8e-3
STEP_TOL = 2e-5
# the reference's float64 Box-Muller against the port's float32 one on
# the same Philox words: float32 rounding of log, sqrt, sin and cos,
# read up to 1.6e-6 of 1 + |eps|
EPS_TOL = 5e-6
# the committed net against N((z + y) / 2, 1/2) on prior rollouts: RMS
# gaps of its mean and its std read 0.037 and 0.030 (seed 1 of the
# trainer's defaults); a net that learned nothing reads ~1
FIT_MEAN_RMS, FIT_STD_RMS = 0.06, 0.05
# a chunk of 8 steps on the card against the reference per particle,
# within CHUNK_TOL of 1 + |reference|: each step's rounding is carried
# through the later moves (K12's plain version reads 1.0e-6 over such a
# chunk on the CPU; the twin up to 9.0e-6 over a query of 2^24 particles
# on an H100, chip_smoke.py's CELL_TOL)
CHUNK_TOL = 5e-5


def _random_net(sizes, seed):
    """A net at the trainer's initial scale (weights N(0, 2 / fan_in),
    biases N(0, 0.1^2)), the raw output's bias lifted by 0.5."""
    rng = np.random.default_rng(seed)
    layers = [{"w": (math.sqrt(2.0 / a) * rng.standard_normal((a, b))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    layers[-1]["b"][1] += 0.5
    return layers


def _committed():
    return [{"w": np.asarray(layer["w"], np.float32), "b": np.asarray(layer["b"], np.float32)}
            for layer in NET["layers"]]


NETS = {"random [3,64,64,2]": lambda: _random_net([3, 64, 64, 2], 11),
        "random [3,48,48,2]": lambda: _random_net([3, 48, 48, 2], 12),
        "committed [3,64,64,2]": _committed}


def _ref_layers(layers, device="cpu"):
    return REF.net_layers({"layers": [{"w": lay["w"].tolist(), "b": lay["b"].tolist()}
                                      for lay in layers]}, device)


def _sizes(layers):
    return [layers[0]["w"].shape[0]] + [lay["w"].shape[1] for lay in layers]


def _scale(layers, x, y, tf):
    """The magnitude of the terms each output sums, in float64."""
    Wd = [torch.as_tensor(lay["w"]).double() for lay in layers]
    bd = [torch.as_tensor(lay["b"]).double() for lay in layers]
    act = torch.relu(x.double()[:, None] * Wd[0][0] + (Wd[0][1] * y + Wd[0][2] * tf + bd[0]))
    scale = act.abs()
    for W, b in zip(Wd[1:], bd[1:]):
        pre = act @ W + b
        scale = scale @ W.abs() + b.abs()
        act = torch.relu(pre)
    return scale


def _inputs(n=4096, seed=2):
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 2, n).astype(np.float32))
    return x, 0.7, float(np.float32(5) / np.float32(T))


def _rel(got, want, scale):
    return float(((got.double() - want.double()).abs() / scale).max())


@pytest.mark.parametrize("name", sorted(NETS))
def test_replay_and_plain_net_match_the_reference_net(name):
    layers = NETS[name]()
    sizes = _sizes(layers)
    x, y, tf = _inputs()
    ref = REF.net_forward(_ref_layers(layers), x, y, tf)
    scale = _scale(layers, x, y, tf)
    packed = torch.as_tensor(pack_weights([lay["w"] for lay in layers],
                                          [lay["b"] for lay in layers]))
    y_t, tf_t = torch.tensor(y), torch.tensor(tf)
    replay = tc_net_plain(packed, sizes, x, y_t, tf_t)
    net = ([torch.as_tensor(lay["w"]) for lay in layers], [torch.as_tensor(lay["b"]) for lay in layers])
    plain = _net_plain(net, x, y_t, tf_t)
    cheap = tc_net_plain(packed, sizes, x, y_t, tf_t, one_tf32=True)
    for k in range(2):
        assert _rel(replay[k], ref[k], scale[:, k]) <= NET_TOL
        assert _rel(plain[k], ref[k], scale[:, k]) <= NET_TOL
    assert max(_rel(cheap[k], ref[k], scale[:, k]) for k in range(2)) > NET_TOL


def _tail(x, w, mean, raw, eps, y, t):
    """The plain version's move and weight from the net's (mean, raw), in
    float32."""
    std = torch.clamp(raw, min=0.0) + torch.log1p(torch.exp(-raw.abs())) + 1e-6
    nx = mean + std * eps
    log_q = -0.5 * eps * eps - torch.log(std) - 0.5 * math.log(2.0 * math.pi)
    tt = torch.tensor(float(t))
    return nx, w + (trans_logpdf_elem(x, nx, tt) + obs_logpdf_elem(nx, y, tt) - log_q)


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("t", [1, 6])
def test_guided_step_matches_the_reference_step(name, t):
    """One move of K12's plain version (its draws pinned to the
    reference's) and of the twin's replay against the reference's
    ``guided_step``; the 1xTF32 replay falls outside."""
    layers = NETS[name]()
    sizes = _sizes(layers)
    x, _, _ = _inputs(seed=3)
    n = x.shape[0]
    w = torch.as_tensor(np.random.default_rng(4).normal(-3, 1, n).astype(np.float32))
    y = float(np.float32(0.35))
    seed = 2 ** 41 + 7
    eps = REF.step_eps(seed, torch.arange(n), t)
    ref_x, ref_dw = REF.guided_step(_ref_layers(layers), CFG, x, y, t, eps)
    ref_w = w.double() + ref_dw
    eps32 = eps.float()
    params = mlp_params_from_numpy(layers, device="cpu")
    px, pw, _ = guided_scalar_chunk_plain(params, trans_logpdf_elem, obs_logpdf_elem, T, seed,
                                          x, w, torch.tensor([y]), t0=t, draws=eps32[None])
    packed = torch.as_tensor(pack_weights([lay["w"] for lay in layers],
                                          [lay["b"] for lay in layers]))
    tf = torch.tensor(float(t)) / float(T)
    y_t = torch.tensor(y)
    tx, tw = _tail(x, w, *tc_net_plain(packed, sizes, x, y_t, tf), eps32, y_t, t)
    cx, cw = _tail(x, w, *tc_net_plain(packed, sizes, x, y_t, tf, one_tf32=True), eps32, y_t, t)

    def err(a, b):
        return float(((a.double() - b).abs() / (1 + b.abs())).max())

    for got_x, got_w in ((px, pw), (tx, tw)):
        assert err(got_x, ref_x) <= STEP_TOL and err(got_w, ref_w) <= STEP_TOL
    assert max(err(cx, ref_x), err(cw, ref_w)) > STEP_TOL


@pytest.mark.parametrize("seed", [5, 2 ** 40 + 12345, 2 ** 63 - 25])
def test_reference_draws_are_the_ports(seed):
    """Philox words bit for bit; each step's eps (cos half at even t, sin
    half at odd t, pair t // 2) within EPS_TOL, launches from odd and even
    t0 alike."""
    g = torch.arange(1 << 14) * 40503 % (1 << 32)
    k0, k1 = split_seed(seed)
    for a, b in zip(REF.philox4x32_10(g, 9, 0, 0, k0, k1), philox4x32(g, 9, 0, 0, k0, k1)):
        assert torch.equal(a, b)
    idx = torch.arange(1 << 14)
    for t0 in (1, 2):
        draws = normal_steps(seed, idx, t0, 5)
        for s in range(5):
            port = next(draws)[0].double()
            ref = REF.step_eps(seed, idx, t0 + s)
            assert float(((port - ref).abs() / (1 + ref.abs())).max()) <= EPS_TOL


def test_committed_net_is_near_the_optimal_proposal():
    """The optimal proposal of x_t ~ N(x_{t-1}, 1), y_t ~ N(x_t, 1) is
    N((x_{t-1} + y_t) / 2, 1/2); the committed net, on the sites of 4,096
    prior rollouts of the series length, within FIT_MEAN_RMS and
    FIT_STD_RMS of it.  Its file holds the sizes the configuration states,
    each weight a float32 that converts back exactly."""
    assert NET["sizes"] == CFG["net_sizes"] == _sizes(_committed())
    for lay in NET["layers"]:
        w = np.asarray(lay["w"], np.float64)
        assert np.array_equal(w.astype(np.float32).astype(np.float64), w)
    layers = REF.net_layers(NET)
    rng = np.random.default_rng(123)
    z = rng.standard_normal(4096)
    d_mean, d_std = [], []
    for t in range(1, T):
        nz = z + rng.standard_normal(z.shape[0])
        y = nz + rng.standard_normal(z.shape[0])
        zs, ys = torch.as_tensor(z), torch.as_tensor(y)
        feats = torch.stack([zs, ys, torch.full_like(zs, t / T)], -1)
        act = feats
        for i, (W, b) in enumerate(layers):
            act = act @ W + b
            if i < len(layers) - 1:
                act = torch.relu(act)
        mean, raw = act[:, 0], act[:, 1]
        std = torch.clamp(raw, min=0.0) + torch.log1p(torch.exp(-raw.abs())) + 1e-6
        d_mean.append(mean - (zs + ys) / 2)
        d_std.append(std - math.sqrt(0.5))
        z = nz
    rms = lambda d: float(torch.cat(d).square().mean().sqrt())
    assert rms(d_mean) <= FIT_MEAN_RMS and rms(d_std) <= FIT_STD_RMS


def test_the_committed_net_builds_the_wide_twin_by_default():
    params = mlp_params_from_numpy(_committed(), device="cpu")
    model = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, params, T, trans_logpdf_elem=trans_logpdf_elem,
        obs_logpdf_elem=obs_logpdf_elem)
    kernel = model.fused_chunk_t_batch.kernel
    assert isinstance(kernel, GuidedTensorCoreKernel) and kernel.wide
    assert kernel.layer_sizes() == [3, 64, 64, 2]


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [True, False])
def test_kernels_match_the_reference_on_the_card(mxu):
    """A chunk of 8 steps from t0 = 1 of 2^16 + 3 particles under the
    committed net, per particle against the reference's ``guided_chunk``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the twin and K12 run only on the card")
    dev = torch.device("cuda")
    n = (1 << 16) + 3
    params = mlp_params_from_numpy(_committed(), device=dev)
    cls = GuidedTensorCoreKernel if mxu else GuidedScalarKernel
    k = cls(params, trans_logpdf_elem, obs_logpdf_elem, T)
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn(n, generator=gen, device=dev)
    w0 = -2.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
    ys = 1.5 * torch.randn(8, generator=gen, device=dev)
    seed = 2 ** 37 + 11
    nv = torch.full((), 8, dtype=torch.int32, device=dev)
    x, w, _ = k.chunk(seed, x0, w0, ys, nv, t0=1)
    rx, rw = REF.guided_chunk(REF.net_layers(NET, dev), CFG, seed, x0, w0, ys.tolist(), 1, 8)
    for got, want in ((x, rx), (w, rw)):
        assert float(((got.double() - want).abs() / (1 + want.abs())).max()) <= CHUNK_TOL
