"""The port's SHERPA-family models (``cpprob_tpu_torch/models/sherpa.py``)
against the JAX package's.

Pinned draws: the JAX model runs under ``Seed``/``TraceHandler`` and its
draws (``channel_u``, ``n_deposits[p]``, ``deposit_eps[p]``, ``deposits``)
are recorded; the port's model runs under ``Substitute`` with those
values.  The histograms agree in total mass within 1e-6 relative and
within an L1 distance of 2·``_E_DEPOSIT`` (a float32 ``cos`` or ``floor``
of the other library may move one deposit across a bin edge), the ABC
log-weight within 1e-5 relative for each ``abc_variance`` and at tempers 1
and 50, and every predict exactly.  Then the cases of
``tests/test_sherpa.py``, with the port's own draws.  Everything runs on
the CPU, where the port's scatter-add sums in a fixed order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu_torch as pt
from cpprob_tpu.core import handlers as jh
from cpprob_tpu.models import sherpa as jsh
from cpprob_tpu_torch.core import handlers as ph
from cpprob_tpu_torch.inference.csis import CSIS
from cpprob_tpu_torch.models import (
    CHANNEL_MOMENTA,
    calo_simulation,
    sherpa_calorimeter_wrapper,
    sherpa_mini,
    sherpa_mini_wrapper,
)
from cpprob_tpu_torch.models import sherpa as psh

torch.set_num_threads(2)

BINS = (7, 7, 5)
M = 256
E_DEP = psh._E_DEPOSIT


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_run(model, args, key, subs=None):
    """The JAX model's draws (every sample site), predicts, log-weight and
    output under ``Seed(key)``."""
    tr, pc, lw = jh.TraceHandler(), jh.PredictCollector(), jh.LogWeight()
    with jh.Substitute(subs or {}), jh.Seed(key), tr, pc, lw:
        out = model(*args)
    draws = {k: np.asarray(v["value"]) for k, v in tr.trace.items() if v["type"] == "sample"}
    predicts = {k: np.asarray(v[0]) for k, v in pc.predicts.items()}
    return draws, predicts, float(lw.log_weight), np.asarray(out)


def _port_run(model, args, draws):
    pc, lw = ph.PredictCollector(), ph.LogWeight()
    subs = {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}
    with ph.Substitute(subs), ph.Seed(gen(99)), pc, lw:
        out = model(*args)
    predicts = {k: v[0].numpy() for k, v in pc.predicts.items()}
    return predicts, float(lw.log_weight), out.numpy()


def _observed(ch):
    """A JAX-simulated calorimeter volume of channel ``ch`` at the test's
    reduced size."""
    tr = jh.TraceHandler()
    with jh.Substitute({"channel_u": jnp.float32(ch + 0.5)}), jh.Seed(jax.random.key(100 + ch)), \
            jh.SimulateObserves(), tr:
        jsh.sherpa_calorimeter_wrapper(jnp.zeros(int(np.prod(BINS))), n_bins=BINS,
                                       max_deposits=M)
    return np.asarray(tr.trace["calo"]["value"])


def _hist_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-6)
    assert np.abs(got - want).sum() <= 2 * E_DEP + 1e-6, np.abs(got - want).sum()


@pytest.mark.parametrize("ch", range(4))
@pytest.mark.parametrize("variance", ["poisson", "reference"])
def test_calorimeter_wrapper_pinned_draws(ch, variance):
    obs = _observed((ch + 1) % 4)
    for temper in (1.0, 50.0):
        kw = dict(n_bins=BINS, max_deposits=M, abc_variance=variance, abc_temper=temper)
        draws, jpred, jlw, jhist = _jax_run(
            lambda o: jsh.sherpa_calorimeter_wrapper(o, **kw), (obs,), jax.random.key(ch),
            {"channel_u": jnp.float32(ch + 0.25)})
        assert set(draws) == {"channel_u"} | {f"{s}[{p}]" for s in ("n_deposits", "deposit_eps")
                                              for p in range(4)}
        ppred, plw, phist = _port_run(
            lambda o: sherpa_calorimeter_wrapper(o, **kw), (obs,), draws)
        _hist_close(phist, jhist)
        np.testing.assert_allclose(plw, jlw, rtol=1e-5)
        assert set(ppred) == set(jpred)
        for k in jpred:
            assert ppred[k] == jpred[k], (k, ppred[k], jpred[k])
        assert int(ppred["Decay Channel"]) == ch


@pytest.mark.parametrize("seed", range(3))
def test_sherpa_mini_pinned_draws(seed):
    with jh.Seed(jax.random.key(50 + seed)):
        image = np.asarray(jsh.sherpa_mini())
    draws, jpred, jlw, jhist = _jax_run(jsh.sherpa_mini_wrapper, (image,),
                                        jax.random.key(seed))
    assert set(draws) == {"channel_u", "deposits"}
    ppred, plw, phist = _port_run(sherpa_mini_wrapper, (image,), draws)
    _hist_close(phist, jhist)
    np.testing.assert_allclose(plw, jlw, rtol=1e-5)
    assert ppred["Channel"] == jpred["Channel"]


def test_abc_temper_scales_pinned_log_weights_exactly():
    obs = _observed(2)
    lws = []
    for temper in (1.0, 50.0):
        draws, _, _, _ = _jax_run(
            lambda o: jsh.sherpa_calorimeter_wrapper(o, n_bins=BINS, max_deposits=M),
            (obs,), jax.random.key(7))
        lws.append(_port_run(lambda o: sherpa_calorimeter_wrapper(
            o, n_bins=BINS, max_deposits=M, abc_temper=temper), (obs,), draws)[1])
    np.testing.assert_allclose(lws[1], lws[0] / 50.0, rtol=1e-6)


# --------------------------------------------------------------------------
# the cases of tests/test_sherpa.py


def _run_prior(model, args, seed):
    pc = ph.PredictCollector()
    with ph.Seed(gen(seed)), ph.SimulateObserves(), pc:
        out = model(*args)
    return out, pc


def test_histogram_mass():
    for seed in range(4):
        img, pc = _run_prior(sherpa_mini, (), seed)
        channel = int(pc.predicts["Channel"][0])
        total_e = float(np.sum(CHANNEL_MOMENTA[: channel + 1, 3]))
        assert float(img.sum()) <= total_e + 1e-4
        assert float(img.sum()) > 0.25 * total_e


def test_wrapper_weights():
    img, _ = _run_prior(sherpa_mini, (), 0)
    res = pt.sis(sherpa_mini_wrapper, (img.numpy(),), 64, 0, device="cpu")
    assert torch.isfinite(res.log_weights).all()


def test_channel_identifiable():
    img, pc = _run_prior(sherpa_mini, (), 123)
    true_channel = int(pc.predicts["Channel"][0])
    res = pt.sis(sherpa_mini_wrapper, (img.numpy(),), 256, 1, device="cpu")
    assert int(res.empirical("Channel").map_estimate(4)) == true_channel


PARTICLES2 = np.array([[1.0, 0.1, 3.0, 5.0, 0.2, 0.1, 211.0, 1.0],
                       [0.5, -0.2, 2.0, 3.0, -0.1, 0.4, 11.0, 1.0]], np.float32)


def test_energy_deposition():
    with ph.Seed(gen(0)):
        hist = calo_simulation(PARTICLES2)
    assert tuple(hist.shape) == (35, 35, 20)
    assert float(hist.sum()) > 0.0
    # a constant a deposit: every voxel holds a whole number of them
    counts = hist.double() / E_DEP
    assert torch.allclose(counts, torch.round(counts), atol=1e-3)


def test_invisible_particle_deposits_nothing():
    p = PARTICLES2[:1].copy()
    p[0, 7] = 0.0
    with ph.Seed(gen(0)):
        hist = calo_simulation(p)
    assert float(hist.sum()) == 0.0


def _one_particle_volume():
    with ph.Seed(gen(5)):
        return calo_simulation(PARTICLES2[:1]).numpy()


def test_full_wrapper_abc():
    res = pt.sis(sherpa_calorimeter_wrapper, (_one_particle_volume(),), 32, 0, device="cpu")
    assert torch.isfinite(res.log_weights).all()
    assert {"Decay Channel", "Momentum X", "Momentum Y", "Momentum Z"} <= set(res.predicts)


def test_abc_temper_scales_log_weights_exactly():
    obs = _one_particle_volume()
    r1 = pt.sis(lambda o: sherpa_calorimeter_wrapper(o, abc_temper=1.0), (obs,), 64, 0,
                device="cpu")
    r50 = pt.sis(lambda o: sherpa_calorimeter_wrapper(o, abc_temper=50.0), (obs,), 64, 0,
                 device="cpu")
    np.testing.assert_allclose(r50.log_weights.numpy(), r1.log_weights.numpy() / 50.0,
                               rtol=1e-5, atol=1e-5)
    assert float(r50.ess) > float(r1.ess)


def test_abc_variance_rejects_unknown():
    with pytest.raises(ValueError, match="abc_variance"):
        with ph.Seed(gen(0)):
            sherpa_calorimeter_wrapper(np.zeros(245, np.float32), n_bins=BINS,
                                       max_deposits=M, abc_variance="bogus")


def test_lstm_obs_embedding_trains():
    from cpprob_tpu_torch.distributions import Normal

    def m(y):
        mu = pt.sample(Normal(0.0, 1.0), addr="mu")
        for i in range(4):
            pt.observe(Normal(mu, 0.5), y[i], addr=f"y[{i}]")
        pt.predict(mu, "Mu")

    eng = CSIS(m, (torch.zeros(4),), obs_embedding="lstm", device="cpu")
    params, losses = eng.compile(0, steps=100, batch_size=64)
    assert float(losses[-1]) < float(losses[0])
    res = eng.infer(params, (torch.full((4,), 1.0),), 2000, 1)
    assert float(res.ess) > 100


def test_cnn3d_obs_embedding_on_the_calorimeter():
    """CNN3D-embedded CSIS on ``sherpa_calorimeter_wrapper`` at the test's
    volume (the structure of the full-scale example)."""
    vox = int(np.prod(BINS))

    def model(observed, temper=1.0):
        return sherpa_calorimeter_wrapper(observed, n_bins=BINS, max_deposits=M,
                                          abc_temper=temper)

    eng = CSIS(model, (torch.zeros(vox), 1.0), embedding_dim=16, obs_embedding="cnn3d",
               obs_shape=BINS, device="cpu")
    params, losses = eng.compile(0, steps=20, batch_size=16, learning_rate=2e-3)
    assert torch.isfinite(losses).all()
    res = eng.infer(params, (torch.as_tensor(_observed(1)), 10.0), 64, 1, defensive=0.3)
    assert torch.isfinite(res.log_weights).all()
    assert set(res.predicts) >= {"Decay Channel", "Momentum X"}
