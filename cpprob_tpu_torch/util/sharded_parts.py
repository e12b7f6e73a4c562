"""Where the time of a sharded SMC sweep goes, at world size 1 over NCCL on
one card: each part of ``parallel/smc.py``'s chunked sweep on the
lg-2^24 population (2^24 particles after one K7 chunk), timed three ways,
then whole sweeps of each scheme beside ``build_smc_run``'s.

    python -m cpprob_tpu_torch.util.sharded_parts

Per part: device ms by CUDA events over back-to-back calls, the host's
enqueue ms of one call (no synchronisation inside it unless the part reads
the host), and the synced host-clock median.  It needs a CUDA card.
"""

from __future__ import annotations

import socket
import statistics
import time

import torch

N = 1 << 24
CHUNK = 8
REPS = 16


def _time(fn, reps=REPS):
    from .roofline import time_ms

    dev_ms = time_ms(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return dev_ms, enqueue, statistics.median(host)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sharded_parts needs a CUDA card")
    import torch.distributed as dist

    from ..inference.smc import build_smc_run
    from ..models.linear_gaussian import linear_gaussian_ssm, simulate_observations
    from ..ops.fused_lg import lg_chunk, make_fused_lg_ssm
    from ..parallel import initialize_multihost, particle_mesh, smc_sharded
    from ..parallel import resampling as pr
    from ..parallel._collectives import all_gather, psum
    from .profiling import gpu_name_and_power

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"localhost:{port}", 1, 0, device="cuda:0")
    try:
        mesh = particle_mesh()
        dev = torch.device("cuda", 0)
        obs = torch.as_tensor(simulate_observations(16, 0), device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x0 = linear_gaussian_ssm.init_sample_batch(gen, N)
        w0 = linear_gaussian_ssm.obs_logpdf_batch(x0, obs[0], 0)
        ys = obs[1:1 + CHUNK].contiguous()
        x, lw, _ = lg_chunk(1, x0, w0, ys, None, t0=1)
        u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
        one = torch.ones(1, device=dev)
        cdf = torch.cumsum(torch.softmax(lw.double(), 0), 0)
        p = (torch.arange(N, dtype=torch.float64, device=dev) + 0.37) / N
        parts = {
            "psum of one float": lambda: psum(one, mesh),
            "all_gather of one float": lambda: all_gather(one, mesh),
            "global_ess": lambda: pr.global_ess(lw, mesh),
            "prefix (exp, cumsum, one all-gather)": lambda: pr._prefix(lw, mesh),
            "searchsorted of 2^24 positions (float64)":
                lambda: torch.searchsorted(cdf, p, right=True),
            "ring epoch": lambda: pr.ring_systematic_resample(u0, lw, x, mesh),
            "balanced epoch": lambda: pr.balanced_systematic_resample(u0, lw, x, mesh),
            "island epoch": lambda: x[pr.local_systematic_ancestors(u0, lw, mesh).long()],
            "K7 chunk": lambda: lg_chunk(1, x, lw, ys, None, t0=9),
        }
        lg = make_fused_lg_ssm()
        single = build_smc_run(lg, N, chunk=CHUNK)
        parts["build_smc_run sweep"] = lambda: single(7, obs)
        for scheme in ("balanced", "collective", "island"):
            parts[f"smc_sharded sweep, {scheme}"] = (
                lambda scheme=scheme: smc_sharded(lg, obs, N, 7, mesh=mesh, chunk=CHUNK,
                                                  scheme=scheme))
        print(gpu_name_and_power())
        print(f"{'part':48s} {'device ms':>10s} {'enqueue ms':>11s} {'synced ms':>10s}")
        for name, fn in parts.items():
            d, e, h = _time(fn)
            print(f"{name:48s} {d:10.4f} {e:11.4f} {h:10.4f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
