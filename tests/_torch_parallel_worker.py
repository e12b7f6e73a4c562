"""One gloo rank of ``tests/test_torch_parallel.py``: runs a job of the
port's multi-device layer on CPU tensors and writes its results to
``<out>/<job>_<rank>.npz``, which the test's parametrised cases read.

    python _torch_parallel_worker.py RANK WORLD INIT_FILE OUT_DIR JOB

The inputs come from numpy seeds that the test shares (``SEEDS``
below), so the test holds the results against the JAX package's on the
same inputs.
"""

import os
import sys

import torch

torch.set_num_threads(1)   # before the port's import warms its threads

import numpy as np  # noqa: E402

N_LOCAL = 1024             # particles a rank in the resampling job
U0S = (0.0, float(np.float32(0.3781)), float(np.float32(0.999)))
SPREADS = (0.1, 3.0)
N_SMC = 4096               # particles in all, the sharded SMC sweeps
N_HMM = 2048
SEEDS = 4


def lg_observations():
    return np.random.RandomState(7).normal(0.0, 1.2, size=16).astype(np.float32)


def hmm_observations():
    return np.linspace(-1.0, 1.0, 8).astype(np.float32)


def resample_inputs(k):
    """(log-weights (N,), scalar states (N,), (N, 2) states) for the ring
    and the ancestors, and the concentrated weights of the fallback."""
    rng = np.random.RandomState(11)
    n = N_LOCAL * k
    lw = rng.normal(0.0, 2.0, size=n).astype(np.float32)
    s1 = rng.normal(size=n).astype(np.float32)
    s2 = rng.normal(size=(n, 2)).astype(np.float32)
    conc = np.where(np.arange(n) // N_LOCAL == 2, 0.0, -80.0).astype(np.float32)
    return lw, s1, s2, conc


def spread_weights(spread, k):
    return np.random.RandomState(int(spread * 10)).normal(
        0.0, spread, size=N_LOCAL * k).astype(np.float32)


def lg_chunk_observations():
    return np.random.RandomState(12).normal(0.0, 1.2, size=25).astype(np.float32)


HALF_LOG_2PI = 0.9189385332046727


def torch_chunk(seed, states, log_w, ys, n_valid):
    """A chunk hook without absolute time in plain PyTorch, the port's twin
    of the reference test's ``xla_chunk``: unit random-walk moves and unit
    Gaussian emissions for ``n_valid`` steps, drawn from a generator
    seeded with the chunk's seed."""
    g = torch.Generator(device=states.device).manual_seed(int(seed))
    x, w = states, log_w
    for i in range(ys.shape[0]):
        nx = x + torch.randn(x.shape, generator=g, device=x.device)
        d = ys[i] - nx
        valid = i < n_valid
        x = torch.where(valid, nx, x)
        w = torch.where(valid, w + (-0.5 * d * d - HALF_LOG_2PI), w)
    p = torch.softmax(w, 0)
    return x, w, 1.0 / torch.sum(p * p)


def _error(fn):
    """The message of the ValueError/TypeError ``fn`` raises ('' if none)."""
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def job_resample(mesh, rank, k):
    from cpprob_tpu_torch.distributions.base import HOST_READS
    from cpprob_tpu_torch.parallel import (
        global_ess,
        global_log_mean_exp,
        local_systematic_ancestors,
        ring_systematic_resample,
        sharded_systematic_ancestors,
    )
    from cpprob_tpu_torch.parallel.resampling import balanced_systematic_resample

    sl = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
    out = {}
    for spread in SPREADS:
        lw = torch.as_tensor(spread_weights(spread, k)[sl])
        out[f"ess_{spread}"] = global_ess(lw, mesh).numpy()
        out[f"lme_{spread}"] = global_log_mean_exp(lw, mesh).numpy()
    lw, s1, s2, conc = (torch.as_tensor(a[sl]) for a in resample_inputs(k))
    for i, u0 in enumerate(U0S):
        out[f"anc_{i}"] = sharded_systematic_ancestors(u0, lw, mesh).numpy()
        out[f"local_{i}"] = local_systematic_ancestors(u0, lw, mesh).numpy()
        out[f"ring1_{i}"] = ring_systematic_resample(u0, lw, s1, mesh).numpy()
        out[f"ring2_{i}"] = ring_systematic_resample(u0, lw, s2, mesh).numpy()
        reads = HOST_READS["smc_sharded"]
        out[f"bal1_{i}"] = balanced_systematic_resample(u0, lw, s1, mesh, bound=256).numpy()
        out[f"bal_reads_{i}"] = np.array(HOST_READS["smc_sharded"] - reads)
        out[f"bal2_{i}"] = balanced_systematic_resample(u0, lw, s2, mesh, bound=256).numpy()
    tree = {"x": torch.as_tensor(resample_inputs(k)[2][sl]),
            "i": torch.arange(rank * N_LOCAL, (rank + 1) * N_LOCAL, dtype=torch.int32)}
    ring_t = ring_systematic_resample(0.42, lw, tree, mesh)
    bal_t = balanced_systematic_resample(0.42, lw, tree, mesh, bound=128)
    out["tree_equal"] = np.array(all(torch.equal(ring_t[n], bal_t[n]) for n in tree))
    out["tree_i"] = ring_t["i"].numpy()
    # concentrated weights: every survivor in shard 2's range
    idx = torch.arange(rank * N_LOCAL, (rank + 1) * N_LOCAL, dtype=torch.float32)
    out["conc_ring"] = ring_systematic_resample(0.9, conc, idx, mesh).numpy()
    out["conc_bal"] = balanced_systematic_resample(0.9, conc, idx, mesh, bound=16).numpy()
    out["conc_none"] = np.array(_error(lambda: balanced_systematic_resample(
        0.9, conc, idx, mesh, bound=16, fallback="none")))
    out["bad_fallback"] = np.array(_error(lambda: balanced_systematic_resample(
        0.9, conc, idx, mesh, fallback="bogus")))
    return out


def job_engines(mesh, rank, k):
    import dataclasses

    from cpprob_tpu_torch.entry import dryrun_multichip
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import (
        HMM_MEANS,
        gaussian_unknown_mean,
        gaussian_unknown_mean_readme,
        hmm_ssm,
        linear_gaussian_ssm,
    )
    from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm
    from cpprob_tpu_torch.parallel import sis_sharded, smc_sharded
    from cpprob_tpu_torch.util.pytree import tree_leaves, tree_map

    out = {}
    ys = torch.as_tensor(lg_observations())
    hy = torch.as_tensor(hmm_observations())
    fused = make_fused_lg_ssm()
    runs = {
        "step_collective": lambda s: smc_sharded(linear_gaussian_ssm, ys, N_SMC, s,
                                                 mesh=mesh, scheme="collective",
                                                 track_fn=lambda x: x),
        "step_balanced": lambda s: smc_sharded(linear_gaussian_ssm, ys, N_SMC, s,
                                               mesh=mesh, scheme="balanced",
                                               balance_bound=256),
        "step_island": lambda s: smc_sharded(linear_gaussian_ssm, ys, N_SMC, s,
                                             mesh=mesh, scheme="island"),
        "chunk_collective": lambda s: smc_sharded(fused, ys, N_SMC, s, mesh=mesh,
                                                  scheme="collective", chunk=4),
        "chunk_balanced": lambda s: smc_sharded(fused, ys, N_SMC, s, mesh=mesh,
                                                scheme="balanced", chunk=4),
        "chunk_island": lambda s: smc_sharded(fused, ys, N_SMC, s, mesh=mesh,
                                              scheme="island", chunk=4),
        "hmm_exchange": lambda s: smc_sharded(hmm_ssm, hy, N_HMM, s, mesh=mesh,
                                              scheme="exchange", ess_threshold=1.0),
        "hmm_island": lambda s: smc_sharded(hmm_ssm, hy, N_HMM, s, mesh=mesh,
                                            scheme="island", ess_threshold=1.0),
        "hmm_collective": lambda s: smc_sharded(
            hmm_ssm, hy, N_HMM, s, mesh=mesh, scheme="collective", ess_threshold=1.0,
            track_fn=lambda z: torch.as_tensor(HMM_MEANS)[z.long()]),
    }
    for name, run in runs.items():
        res = [run(s) for s in range(SEEDS)]
        out[f"{name}_lz"] = np.array([float(r.log_evidence) for r in res])
        out[f"{name}_epochs"] = np.array([int(r.resampled.sum()) for r in res])
        out[f"{name}_states0"] = res[0].final_states.numpy()
        out[f"{name}_lw0"] = res[0].final_log_weights.numpy()
        out[f"{name}_ess0"] = res[0].ess_history.numpy()
        if res[0].tracked is not None:
            out[f"{name}_tracked"] = np.stack([r.tracked.numpy() for r in res])
    # a model that brings its own chunk hook without absolute time
    own = dataclasses.replace(linear_gaussian_ssm, fused_chunk_batch=torch_chunk)
    cy = torch.as_tensor(lg_chunk_observations())
    for scheme in ("balanced", "collective"):
        r = smc_sharded(own, cy, 16384, 0, mesh=mesh, scheme=scheme, chunk=4,
                        balance_bound=512 if scheme == "balanced" else None)
        out[f"own_{scheme}"] = np.array([float(r.log_evidence), int(r.resampled.sum())])
        out[f"own_{scheme}_states"] = r.final_states.numpy()
    disc = dataclasses.replace(fused, state_categories=3)
    errors = {
        "scheme": lambda: smc_sharded(linear_gaussian_ssm, ys, N_SMC, 0, mesh=mesh,
                                      scheme="bogus"),
        "exchange_categories": lambda: smc_sharded(linear_gaussian_ssm, ys, N_SMC, 0,
                                                   mesh=mesh, scheme="exchange"),
        "chunk_hook": lambda: smc_sharded(linear_gaussian_ssm, ys, N_SMC, 0, mesh=mesh,
                                          chunk=4),
        "chunk_track": lambda: smc_sharded(fused, ys, N_SMC, 0, mesh=mesh, chunk=4,
                                           track_fn=lambda x: x),
        "exchange_chunk": lambda: smc_sharded(disc, ys, N_SMC, 0, mesh=mesh,
                                              scheme="exchange", chunk=4),
        "divide": lambda: smc_sharded(linear_gaussian_ssm, ys, N_SMC + 1, 0, mesh=mesh),
        "sis_divide": lambda: sis_sharded(gaussian_unknown_mean, (3.0, 4.0), 1001, 0,
                                          mesh=mesh),
    }
    for name, fn in errors.items():
        out[f"err_{name}"] = np.array(_error(fn))

    res = sis_sharded(gaussian_unknown_mean, (3.0, 4.0), 4096 * k, 2, mesh=mesh)
    out["sis"] = np.array([float(res.mean("Mu")), float(res.variance("Mu")),
                           float(res.ess), float(res.log_evidence), res.num_particles])
    out["sis_local_lw"] = res.log_weights.numpy()
    out["sis_local_mu"] = res.predicts["Mu"].numpy()
    out["sis_nw"] = res.normalized_weights.numpy()
    emp = res.empirical("Mu")
    out["sis_emp_values"] = emp.values.numpy()
    out["sis_emp_lw"] = emp.log_weights.numpy()
    out["sis_emp_mean"] = np.array(float(emp.mean))

    # one data-parallel step on a pinned batch: this rank's rows of it
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=8, device="cpu")
    gen = torch.Generator().manual_seed(5)
    values, obs = eng._gen(gen, 16 * k)
    rows = slice(rank * 16, (rank + 1) * 16)
    mine = tree_map(lambda v: v[rows], values)
    params, losses = eng._train(eng.init(0), 1e-3, iter([(mine, obs[rows])]), None, None,
                                1, mesh=mesh)
    out["dp_batch_obs"] = obs.numpy()
    out["dp_params"] = np.concatenate([t.reshape(-1).numpy() for t in tree_leaves(params)])
    out["dp_loss"] = losses.numpy()

    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=32, device="cpu")
    params, losses = eng.compile(0, steps=120, batch_size=128, mesh=mesh)
    out["compile_losses"] = losses.numpy()
    out["compile_params"] = np.concatenate([t.reshape(-1).numpy()
                                            for t in tree_leaves(params)])
    res = eng.infer(params, (3.0, 4.0), 32_000, 1, mesh=mesh)
    out["infer"] = np.array([float(res.mean("Mean")), float(res.ess),
                             float(res.variance("Mean"))])
    out["err_infer_kwargs"] = np.array(_error(lambda: eng.infer(
        params, (3.0, 4.0), 32_000, 1, mesh=mesh, batch_size=4000)))
    out["err_compile_divide"] = np.array(_error(lambda: eng.compile(
        0, steps=1, batch_size=130, mesh=mesh)))
    out["err_compile_dro"] = np.array(_error(lambda: eng.compile(
        0, steps=1, batch_size=130, mesh=mesh, dro_rho=0.1)))

    got = dryrun_multichip(k, device="cpu")
    out["dryrun"] = np.array([got[n] for n in sorted(got)])
    out["dryrun_keys"] = np.array(sorted(got))
    return out


def job_pair(mesh, rank, k):
    """A world of 2: one data-parallel step with ``dro_rho`` on pinned
    traces, 16 a rank, and a one-rank sub-mesh running ``smc_sharded`` on
    rank 0 while rank 1 stays out of its collectives."""
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import gaussian_unknown_mean_readme, linear_gaussian_ssm
    from cpprob_tpu_torch.parallel import particle_mesh, sis_sharded, smc_sharded
    from cpprob_tpu_torch.parallel.mesh import in_mesh
    from cpprob_tpu_torch.util.pytree import tree_leaves, tree_map

    out = {}
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=8, device="cpu")
    values, obs = eng._gen(torch.Generator().manual_seed(5), 16 * k)
    rows = slice(rank * 16, (rank + 1) * 16)
    mine = tree_map(lambda v: v[rows], values)
    params, losses = eng._train(eng.init(0), 1e-3, iter([(mine, obs[rows])]), None, None,
                                1, dro_rho=DRO_RHO, mesh=mesh)
    out["dro_params"] = np.concatenate([t.reshape(-1).numpy() for t in tree_leaves(params)])
    out["dro_loss"] = losses.numpy()
    _, losses = eng.compile(0, steps=3, batch_size=32, mesh=mesh, dro_rho=DRO_RHO)
    out["dro_compile_losses"] = losses.numpy()

    ys = torch.as_tensor(lg_observations())
    sub = particle_mesh(devices=[0], device="cpu")      # every rank calls it
    out["in_sub"] = np.array(in_mesh(sub))
    if in_mesh(sub):
        out["sub_lz"] = np.array([float(smc_sharded(
            linear_gaussian_ssm, ys, N_SMC, s, mesh=sub, scheme="collective").log_evidence)
            for s in range(SEEDS)])
        out["sub_sis_n"] = np.array(sis_sharded(
            gaussian_unknown_mean_readme, (3.0, 4.0), 64, 0, mesh=sub).num_particles)
    else:
        out["sub_outside"] = np.array(_error(lambda: smc_sharded(
            linear_gaussian_ssm, ys, N_SMC, 0, mesh=sub)))
    out["full_lz"] = np.array([float(smc_sharded(
        linear_gaussian_ssm, ys, N_SMC, s, mesh=mesh, scheme="collective").log_evidence)
        for s in range(SEEDS)])
    out["bad_ranks"] = np.array(_error(lambda: particle_mesh(devices=[0, 0], device="cpu")))
    return out


DRO_RHO = 0.5


def main():
    rank, world, init, out_dir, job = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    import torch.distributed as dist

    from cpprob_tpu_torch.parallel import initialize_multihost, particle_mesh

    initialize_multihost(f"file://{init}", world, rank, device="cpu", timeout=120)
    try:
        mesh = particle_mesh(device="cpu")
        out = {"resample": job_resample, "engines": job_engines,
               "pair": job_pair}[job](mesh, rank, world)
        np.savez(os.path.join(out_dir, f"{job}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    print(f"[{rank}] OK")


if __name__ == "__main__":
    main()
