"""The example twins (``cpprob_tpu_torch/examples``) on the CPU at their
quick mode or smallest flags: each runs through ``main(argv)`` with
``--device cpu`` and its printed record carries the reference example's
keys (the key sets below are the reference's, ``examples/<name>.py``).
The reference examples themselves are not run here: the JAX package's
own tests cover them."""

import json
import os

import numpy as np
import pytest
import torch

from cpprob_tpu_torch.examples import (
    calo_variance,
    csis_bench,
    external_simulator,
    kernel_bench,
    posterior_parse_bench,
    quickstart,
    sherpa_fullscale,
    sherpa_gen,
    thesis_hmm_comparison,
)

torch.set_num_threads(2)

CPU = ["--device", "cpu"]

# the record keys of the reference examples
SHERPA_KEYS = {"experiment", "reference", "device", "volume", "max_deposits", "train",
               "channel_recovery", "operating_point", "accuracy_vs_temper_tradeoff",
               "untempered_point", "defensives_swept", "abc_tempers", "abc_note",
               "guided_channel_correct_count_at_temper1", "versions"}
EXTERNAL_KEYS = {"experiment", "reference", "simulator", "n_compile_traces_traced",
                 "n_compile_traces_eager", "n_particles", "n_seeds", "true_channel",
                 "true_energy", "prior_channel_posterior", "guided_channel_posterior",
                 "eager_guided_channel_posterior", "mean_ess_prior", "mean_ess_guided",
                 "ess_ratio_guided_over_prior", "reference_posterior_energy_mean",
                 "reference_posterior_energy_seeds",
                 "energy_abs_err_guided_vs_reference_posterior",
                 "energy_abs_err_guided_vs_truth", "energy_abs_err_prior_vs_truth",
                 "guided_energy_means", "throughput_particles_per_s", "gates_enforced",
                 "seams"}
KERNEL_KEYS = {"artifact", "device", "n_particles", "T", "discrete_5state_spec_kernel",
               "linear_gaussian_live_resampling", "linear_gaussian_guided_fused",
               "discrete_5state_guided_fused", "resample_epoch", "stages", "versions"}
CSIS_KEYS = {"versions", "experiment", "reference", "device", "T", "train", "accuracy",
             "sweep_device", "guided_infer", "errors"}
PARSE_KEYS = {"experiment", "reference", "dump_mb", "n_particles", "entries",
              "load_posterior_native_s", "load_posterior_python_s", "speedup_public_api",
              "statsprinter_from_dump_s", "parity"}


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_every_twin_takes_device_and_needs_a_card():
    for mod in (calo_variance, csis_bench, external_simulator, kernel_bench,
                posterior_parse_bench, quickstart, sherpa_fullscale, sherpa_gen,
                thesis_hmm_comparison):
        assert mod.build_parser().parse_args([]).device == "cuda", mod.__name__
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                mod.main([])


def test_sherpa_fullscale_quick(tmp_path, capsys):
    out = tmp_path / "sherpa.json"
    payload = sherpa_fullscale.main(["--quick", "--out", str(out), *CPU])
    assert SHERPA_KEYS <= set(payload)
    assert payload["volume"] == [7, 7, 5] and payload["max_deposits"] == 256
    assert payload["train"]["steps"] == 40 and payload["train"]["traces_per_sec"] > 0
    assert len(payload["channel_recovery"]) == 4
    assert all(len(r["by_tolerance"]) == 5 for r in payload["channel_recovery"])
    assert json.loads(out.read_text())["operating_point"] == payload["operating_point"]
    assert _last_json(capsys.readouterr().out)["metric"] == "sherpa_fullscale_traces_per_sec"


def test_external_simulator_smallest(capsys):
    rec = external_simulator.main(["--traces", "400", "--particles", "256", "--seeds", "2",
                                   *CPU])
    assert EXTERNAL_KEYS <= set(rec)
    assert not rec["gates_enforced"]
    # a guided call: the model run once for the observation vector, once
    # for the population
    assert rec["guided_call"]["exchanges"] == 2 == rec["guided_call"]["host_reads"]
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(rec))


def test_kernel_bench_quick(monkeypatch, capsys):
    # the smallest run: short training, one timed iteration a path
    monkeypatch.setattr(kernel_bench, "ITERS", 1)
    monkeypatch.setattr(kernel_bench, "TRAIN_FRACTION", 0.05)
    rec = kernel_bench.main(["--n", "12", *CPU])
    assert KERNEL_KEYS <= set(rec)
    spec = rec["discrete_5state_spec_kernel"]
    assert abs(spec["log_evidence_mean"] - spec["exact_log_evidence"]) < (
        4 * spec["log_evidence_std"] / np.sqrt(spec["sweeps"]) + 0.2)
    lg = rec["linear_gaussian_live_resampling"]
    assert lg["resample_epochs_mean"] >= 1
    assert set(_last_json(capsys.readouterr().out)) == set(rec)


def test_csis_bench_smallest(monkeypatch, capsys):
    monkeypatch.setattr(csis_bench, "GUIDED_PARTICLES", 1024)
    monkeypatch.setattr(csis_bench, "GUIDED_STEPS", 5)
    rec = csis_bench.main(["--train-steps", "5", "--batch-size", "32", "--seeds", "1",
                           *CPU])
    assert CSIS_KEYS <= set(rec)
    assert [r["n_particles"] for r in rec["accuracy"]] == [10, 100, 1000, 10_000]
    assert rec["guided_infer"]["n_particles"] == 1024


def test_posterior_parse_bench_smallest(capsys):
    rec = posterior_parse_bench.main(["--particles", "4096", *CPU])
    if rec is None:
        pytest.skip("the native parser did not build on this host")
    assert PARSE_KEYS <= set(rec)
    assert rec["entries"] == 4096 * 16


def test_quickstart_quick(capsys):
    means = quickstart.main(["--quick", *CPU])
    assert set(means) == {"SIS", "CSIS", "temperedSMC", "HMC", "NUTS", "SVI"}
    out = capsys.readouterr().out
    assert out.count("(exact 2.3235 / 1.0588)") == 6
    for name in ("SIS", "CSIS", "temperedSMC", "HMC"):
        assert abs(means[name] - 2.32353) < 0.3, (name, means[name])


def test_thesis_hmm_comparison_quick(capsys):
    rows = thesis_hmm_comparison.main(["--quick", *CPU])
    assert [r["n_particles"] for r in rows] == [10, 100]
    out = capsys.readouterr().out
    assert "SIS_L2" in out and "CSIS_KL" in out
    assert all(np.isfinite(list(r.values())).all() for r in rows)


def test_sherpa_gen(tmp_path, capsys):
    paths = sherpa_gen.main(["-n", "3", "--channel", "2", "--out", str(tmp_path), *CPU])
    assert len(paths) == 3 and all(p.endswith("_ch2.npy") for p in paths)
    img = np.load(paths[0])
    assert img.shape == (100, 100) and img.sum() > 0
    assert "channel 2" in capsys.readouterr().out


def test_calo_variance(tmp_path, capsys):
    out = tmp_path / "calo.npz"
    mean, var = calo_variance.main(["-n", "8", "--out", str(out), *CPU])
    assert mean.shape == (35, 35, 20) and mean.sum() > 0 and (var >= 0).all()
    np.testing.assert_array_equal(np.load(out)["mean"], mean)
    assert "voxels occupied" in capsys.readouterr().out


def test_external_child_runs_as_a_module():
    """The twin spawns itself with ``-m ... --simulator``; the child answers
    the handshake with its observation size."""
    from cpprob_tpu_torch.external import SubprocessSimulator

    with SubprocessSimulator(external_simulator.child_argv(), external_simulator.OBS_DIM) as s:
        assert s(np.array([0.0, 20.0])).shape == (external_simulator.OBS_DIM,)
    assert os.environ["PYTHONPATH"]
