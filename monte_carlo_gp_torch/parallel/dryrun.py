"""One process of the multi-process dryrun: the counterpart of the JAX
package's `tests/multihost_worker.py`, kept in the package so that it runs
where there is no jax.

    python -m monte_carlo_gp_torch.parallel.dryrun <addr> <world> <rank> <out.npy> \\
        <engine> <device> [--backend gloo|nccl] [--sims N] [--laps L] [--seed S] \\
        [--params fields.npz]

Each of `world` processes joins the process group at `addr` ("host:port")
and runs the split Monte Carlo on the default mesh, which under a group is
the process's own device (`device`, "cpu" or "cuda": its current CUDA
device): `engine` "pallas" is the race kernel
(`run_monte_carlo_kernel_sharded`: K1 on CUDA, its plain version on the
CPU), "xla" the lap engine (`sharded_monte_carlo`). Process 0 writes the
(D, D) probabilities to `out.npy`, which are bitwise those of one process
at the same seed (tests/test_torch_multihost.py), and beside them
`out.json`: the run's seconds and the time of one all-reduce of the
counts. The field is the JAX worker's 20-driver field unless `--params`
names an .npz of SimParams fields.

The order is the JAX worker's: build (or load) the CUDA kernels and touch
the device first, then wait at a barrier, then run, so that no rank's first
collective waits on another rank's compiler.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

D_DRIVERS, LAPS, N_SIMS, SEED = 20, 12, 2_048, 11
ALLREDUCE_REPEATS = 20


def dryrun_params(device="cpu"):
    """The JAX worker's field (tests/multihost_worker.py::dryrun_params)."""
    from monte_carlo_gp_torch.config import make_sim_params

    d = D_DRIVERS
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0).astype(np.float32)
    gp /= gp.sum(1, keepdims=True)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90 + 0.06 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
        device=device,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch.parallel.dryrun",
        description="One process of a split Monte Carlo over a process group",
    )
    parser.add_argument("addr", help="the coordinator, host:port")
    parser.add_argument("world", type=int)
    parser.add_argument("rank", type=int)
    parser.add_argument("out", type=Path, help="where process 0 writes the probabilities")
    parser.add_argument("engine", choices=["pallas", "xla"])
    parser.add_argument("device", choices=["cpu", "cuda"])
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="default: nccl on cuda, gloo on cpu")
    parser.add_argument("--sims", type=int, default=N_SIMS)
    parser.add_argument("--laps", type=int, default=LAPS)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--params", type=Path, default=None,
                        help=".npz of SimParams fields (default: the 20-driver field)")
    return parser


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    from monte_carlo_gp_torch.config import sim_params_from_numpy
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.ops.engine import engine_counts
    from monte_carlo_gp_torch.parallel import distributed
    from monte_carlo_gp_torch.parallel.mesh import sharded_monte_carlo

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("dryrun: device cuda, but torch.cuda.is_available() is False")
        # under NCCL the card initialize_distributed will select, so the
        # inputs lie on the device of the default mesh under the group
        if args.backend == "gloo":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = distributed.select_device(args.rank)
    else:
        device = torch.device("cpu")
    if args.params is None:
        params = dryrun_params(device)
    else:
        with np.load(args.params) as f:
            params = sim_params_from_numpy({k: f[k] for k in f.files}, device)

    # build, load and touch everything the run needs before the rendezvous
    if args.engine == "pallas":
        warm = rk.run_monte_carlo_kernel(params, args.seed, 1, 1)
    else:
        warm = engine_counts(params, args.seed, 1, 1)
    sync(device)
    del warm

    if not distributed.initialize_distributed(
        args.addr, args.world, args.rank, backend=args.backend, device=device
    ):
        sys.exit("dryrun: no process group was formed")
    try:
        distributed.barrier("dryrun_built")
        t0 = time.perf_counter()
        if args.engine == "pallas":
            probs = rk.run_monte_carlo_kernel_sharded(params, args.seed, args.sims, args.laps)
        else:
            probs = sharded_monte_carlo(params, args.seed, args.sims, args.laps)
        sync(device)
        run_s = time.perf_counter() - t0

        # one all-reduce of the run's (D, D) counts, timed apart from the run
        d = params.n_drivers
        dtype = torch.int32 if args.engine == "pallas" and device.type == "cuda" else torch.int64
        counts = torch.zeros((d, d), dtype=dtype, device=device)
        distributed.all_reduce_counts(counts)  # warm
        sync(device)
        t0 = time.perf_counter()
        for _ in range(ALLREDUCE_REPEATS):
            distributed.all_reduce_counts(counts)
        sync(device)
        allreduce_ms = (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPEATS
        distributed.barrier("dryrun_done")
    finally:
        torch.distributed.destroy_process_group()

    report = {
        "rank": args.rank, "world": args.world, "engine": args.engine,
        "device": str(device), "backend": args.backend or ("nccl" if device.type == "cuda" else "gloo"),
        "drivers": params.n_drivers, "laps": args.laps, "sims": args.sims,
        "run_s": run_s, "allreduce_ms": allreduce_ms,
    }
    if args.rank == 0:
        np.save(args.out, probs.cpu().numpy())
        args.out.with_suffix(".json").write_text(json.dumps(report))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
