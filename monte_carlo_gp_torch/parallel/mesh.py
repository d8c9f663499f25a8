"""Device meshes and the single-race sharded lap engine: the counterpart of
`monte_carlo_gp_tpu/parallel/mesh.py`.

The simulation batch is embarrassingly parallel: a mesh of W shards gives
shard i the simulations [floor(i n / W), floor((i + 1) n / W)), each shard
simulates its range on its own device, and the only cross-shard traffic is
the sum of the (D, D) integer finish histograms (one all-reduce across
processes). Every engine of the port draws from Philox keyed by the global
simulation index, so the summed counts, and the probabilities, are bitwise
those of one device for any shard count and any split
(tests/test_torch_sharding.py).

A `Mesh` here is an ordered list of devices with named axes whose sizes
multiply to its length. Every entry is one shard, and a device may appear
more than once, so one card (or the CPU) can hold a split. All axes fold
into the simulation split, as the JAX package's season path folds a
(race, sims) mesh: the races of a season run one after another.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.ops.engine import engine_counts
from monte_carlo_gp_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`devices` in shard order, and the axes they are laid out on."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def default_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """Every visible CUDA device for a CUDA `device` (the default where one
    is present), else the CPU alone. Under a process group a process holds
    only its own CUDA device, the current one (`initialize_distributed`
    selects it from LOCAL_RANK under NCCL), so no card is run by several
    processes at once."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")]
    if distributed.is_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A mesh from {axis_name: size} over the first prod(sizes) of
    `devices` (default `default_devices()`); by default all of them on one
    'sims' axis. Raises ValueError for a mesh larger than the device list."""
    devices = [torch.device(d) for d in (default_devices() if devices is None else devices)]
    if axis_sizes is None:
        axis_sizes = {"sims": len(devices)}
    n = math.prod(axis_sizes.values())
    if n > len(devices):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(devices)}")
    if n < 1:
        raise ValueError(f"mesh {axis_sizes} has no shard")
    return Mesh(tuple(devices[:n]), tuple(axis_sizes), tuple(axis_sizes.values()))


def resolve_mesh(mesh: Mesh | None, device: str | torch.device) -> Mesh:
    """`mesh`, or the default mesh of `device`'s kind: every visible CUDA
    device for a CUDA device (this process's own under a process group),
    the CPU for the CPU."""
    return mesh if mesh is not None else make_mesh(devices=default_devices(device))


def shard_range(n_sims: int, n_shards: int, i: int) -> tuple[int, int]:
    """Shard i's simulations [lo, hi) of n_sims split over n_shards:
    lo = floor(i n / W), hi = floor((i + 1) n / W), so the shards differ by
    at most one simulation and together cover [0, n_sims) once."""
    if not 0 <= i < n_shards:
        raise ValueError(f"shard {i} is not in [0, {n_shards})")
    return i * n_sims // n_shards, (i + 1) * n_sims // n_shards


def local_shards(
    mesh: Mesh, n_sims: int, device: torch.device
) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi) of this process's shards of a run whose inputs lie
    on `device`: with a process group up the global shard index of local
    shard i is rank * mesh.size + i, out of world_size * mesh.size shards
    (every process holds a mesh of the same size). Raises ValueError for a
    mesh with a shard of another device type than the inputs': a split runs
    where its inputs lie, and never moves work between the card and the
    CPU."""
    others = sorted({str(d) for d in mesh.devices if d.type != device.type})
    if others:
        raise ValueError(
            f"the inputs lie on {device}, but the mesh has shards on {', '.join(others)}: "
            "every shard must be a device of the inputs' type"
        )
    rank, world = distributed.world()
    n_shards = world * mesh.size
    return [
        (dev, *shard_range(n_sims, n_shards, rank * mesh.size + i))
        for i, dev in enumerate(mesh.devices)
    ]


def sharded_engine_counts(
    params_list: list[SimParams], seeds: list[int], n_sims: int, race_laps: list[int],
    mesh: Mesh,
) -> torch.Tensor:
    """(R, D, D) int64 lap-engine counts of R races of one width on the
    first race's device: every race's simulations split over the mesh (and
    the process group), the shards' counts summed and then all-reduced
    once."""
    home = params_list[0].device
    total = None
    for dev, lo, hi in local_shards(mesh, n_sims, home):
        if hi == lo:
            continue
        part = torch.stack([
            engine_counts(p.to(dev), seed, hi - lo, laps, sim_offset=lo)
            for p, seed, laps in zip(params_list, seeds, race_laps)
        ]).to(home)
        total = part if total is None else total + part
    if total is None:  # this process's shards hold no simulation
        d = params_list[0].n_drivers
        total = torch.zeros((len(params_list), d, d), dtype=torch.int64, device=home)
    return distributed.all_reduce_counts(total)


def run_monte_carlo_sharded(
    params: SimParams, seed: int, n_sims: int, race_laps: int, mesh: Mesh | None = None
) -> torch.Tensor:
    """`ops.engine.run_monte_carlo` with the simulations split over `mesh`
    (default: that of the params' device, see `resolve_mesh`) and the
    process group: (D, D) float32 probabilities on the params' device,
    bitwise equal to the unsplit run at the same seed for any n_sims (the
    shard ranges split it exactly). The weekend's lap-engine route."""
    if n_sims < 1:
        raise ValueError(f"n_sims must be >= 1, got {n_sims}")
    mesh = resolve_mesh(mesh, params.device)
    counts = sharded_engine_counts([params], [seed], n_sims, [race_laps], mesh)[0]
    return counts.to(torch.float32) / n_sims


def sharded_monte_carlo(
    params: SimParams, seed: int, n_sims: int, race_laps: int, mesh: Mesh | None = None
) -> torch.Tensor:
    """The JAX package's `sharded_monte_carlo`: `run_monte_carlo_sharded`,
    with its rule that n_sims divides evenly over the shards (the mesh's
    times the process count)."""
    mesh = resolve_mesh(mesh, params.device)
    n_shards = distributed.world()[1] * mesh.size
    if n_sims % n_shards != 0:
        raise ValueError(
            f"n_sims={n_sims} must divide evenly over the mesh ({n_shards} shards)"
        )
    return run_monte_carlo_sharded(params, seed, n_sims, race_laps, mesh)
