"""Multi-process runtime: the counterpart of
`monte_carlo_gp_tpu/parallel/distributed.py` on `torch.distributed`.

Every process runs the same program on its own devices (its mesh, see
`parallel/mesh.py`); `initialize_distributed` joins the processes into one
process group, after which the sharded entries (`ops/race_kernel`'s
`race_counts_sharded` and `season_counts_sharded`, the lap engine's
`sharded_monte_carlo` and `simulate_season_sharded`) give process `rank` the
global shards `rank * local_shards + i` and sum the int32 histograms with
`all_reduce_counts`, the only cross-process traffic. Every draw is Philox
keyed by the global simulation index, so the probabilities are bitwise those
of one process for any process count (tests/test_torch_multihost.py, through
`parallel/dryrun.py`).

The CLIs do not join a group, as the JAX package's CLIs do not: several
processes are a library path.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# Generous: ranks may reach the rendezvous minutes apart while each builds
# the CUDA kernels or imports on an oversubscribed host.
TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Join this process into a process group; True when one was formed.

    The arguments default from the standard torch.distributed environment:
    the address from MASTER_ADDR and MASTER_PORT ("host:port"), the world
    size from WORLD_SIZE and the rank from RANK. A single process (no world
    size, or 1) forms no group and gets False, unless a `backend` is named:
    then a world of one is formed too, which checks that the backend's
    collective runs on this machine.

    The default backend is "nccl" when `device` (default: "cuda" where a
    CUDA device is present) is a CUDA device and "gloo" on the CPU. Under
    NCCL the process selects CUDA device LOCAL_RANK (default: the rank)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 and backend is None:
        return False
    if coordinator_address is None:
        raise ValueError(
            "a process group needs the coordinator's address: pass "
            "coordinator_address='host:port' or set MASTER_ADDR and MASTER_PORT"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        select_device(process_id)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )
    return True


def select_device(process_id: int) -> torch.device:
    """Make CUDA device LOCAL_RANK (default: `process_id`) this process's
    current device, as NCCL needs one card per process, and return it. The
    default mesh under a process group is this device alone
    (`parallel.mesh.default_devices`)."""
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    return torch.device("cuda", torch.cuda.current_device())


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier(name: str) -> None:
    """Wait until every process of the group reaches a barrier; a no-op
    without a group, so library code can call it unconditionally. `name`
    says in logs and tracebacks which barrier a process waits at.

    Callers build the CUDA kernels before it (tests/multihost_worker.py's
    discipline): ranks then leave it together, and the first collective
    does not wait on another rank's compiler."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_counts(counts: torch.Tensor) -> torch.Tensor:
    """The sum over every process of the (D, D) or (R, D, D) integer counts,
    in place, by one `all_reduce(SUM)`; `counts` as it is without a group.
    Integer sums are exact in any order, so the result does not depend on
    the process count. Gloo reduces CUDA tensors as well as CPU ones, so
    the counts stay on their device under either backend."""
    if is_initialized():
        dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return counts
