"""The port's multi-process path, after tests/test_multihost.py: N separate
Python processes, each on the default mesh under its group (its own CPU
shard), joined by
`torch.distributed` with gloo through `monte_carlo_gp_torch.parallel.dryrun`.
The split Monte Carlo must give probabilities bitwise equal to the
single-process run, on the race kernel (its plain version here) and on the
lap engine: Philox keyed by the global simulation index and an integer
all-reduce know nothing of the process layout.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.ops import engine
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.parallel import distributed
from monte_carlo_gp_torch.parallel.dryrun import LAPS, N_SIMS, SEED, dryrun_params
from monte_carlo_gp_torch.parallel.mesh import default_devices, resolve_mesh

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_barrier_is_noop_without_a_process_group():
    """`barrier` and `all_reduce_counts` must be callable in one process
    without a group, so library code can call them unconditionally."""
    assert not distributed.is_initialized()
    distributed.barrier("not-distributed")  # must not raise
    counts = torch.arange(6, dtype=torch.int32).view(2, 3)
    assert distributed.all_reduce_counts(counts) is counts
    assert distributed.world() == (0, 1)


def test_one_process_forms_no_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    assert distributed.initialize_distributed(num_processes=1) is False
    assert not distributed.is_initialized()
    with pytest.raises(ValueError, match="address"):
        distributed.initialize_distributed(num_processes=2, process_id=0)


def test_default_mesh_under_a_group_is_the_process_device(monkeypatch):
    """Under a process group each process's default CUDA mesh is its own
    current device, not every visible card: W processes on W cards then run
    one card each. Without a group it is every visible card. The card count
    and the current device are faked, so this runs on the CPU in a gloo
    world of one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert default_devices("cuda") == [torch.device("cuda", i) for i in range(4)]
    assert distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                              backend="gloo", device="cpu")
    try:
        assert default_devices("cuda") == [torch.device("cuda", 2)]
        assert resolve_mesh(None, "cuda").devices == (torch.device("cuda", 2),)
        assert resolve_mesh(None, "cpu").devices == (torch.device("cpu"),)
    finally:
        torch.distributed.destroy_process_group()
    assert not distributed.is_initialized()


def _run_workers(tmp_path, engine_name: str, n_procs: int = 4):
    """Launch N gloo-joined one-shard workers; return process 0's saved
    probabilities. One retry: on an oversubscribed host a rendezvous can
    time out (a scheduling flake, not a property of the code under test)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}

    def attempt(out):
        addr = f"127.0.0.1:{_free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "monte_carlo_gp_torch.parallel.dryrun", addr,
                 str(n_procs), str(i), str(out), engine_name, "cpu"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            for i in range(n_procs)
        ]
        try:
            outputs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [(p.returncode, se.decode()[-2000:]) for p, (_, se) in zip(procs, outputs)]

    out = tmp_path / f"mp_probs_{engine_name}.npy"
    results = attempt(out)
    if any(rc != 0 for rc, _ in results):
        out = tmp_path / f"mp_probs_{engine_name}_retry.npy"
        results = attempt(out)
    for rc, err in results:
        assert rc == 0, err
    assert out.exists() and out.with_suffix(".json").exists()
    return np.load(out)


@pytest.mark.parametrize("engine_name", ["pallas", "xla"])
def test_multiprocess_split_is_bitwise_one_process(engine_name, tmp_path):
    """20 drivers x 12 laps x 2,048 simulations over 4 gloo-joined
    processes: rank 0's probabilities equal the one-process run bitwise."""
    multi = _run_workers(tmp_path, engine_name)
    params = dryrun_params()
    if engine_name == "pallas":
        single = rk.run_monte_carlo_kernel(params, SEED, N_SIMS, LAPS)
    else:
        single = engine.run_monte_carlo(params, SEED, N_SIMS, LAPS)
    np.testing.assert_array_equal(multi, single.numpy())
    np.testing.assert_allclose(multi.sum(axis=1), 1.0, atol=1e-5)
