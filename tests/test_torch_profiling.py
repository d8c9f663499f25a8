"""The profiler trace of the port (`utils/profiling.trace`, the CLI's
`--trace DIR`), the twin of the JAX package's `jax.profiler` trace
(`monte_carlo_gp_tpu/utils/profiling.py:52-64`, `main.py:140-150`).

On the CPU the trace holds the phases and the plain version's operators.
The CUDA side (device events of the ctypes-launched kernels) is read on the
card by `chip_smoke.py`; here a stand-in profiler shows that a CUDA trace
with no device event raises and writes nothing.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from monte_carlo_gp_torch.__main__ import run
from monte_carlo_gp_torch.utils import profiling
from monte_carlo_gp_torch.utils.profiling import TraceError, trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WEEKEND = ["--race", "Bahrain", "--season", "2024", "--synthetic", "--device", "cpu",
           "--simulations", "512", "--seed", "0"]
PHASES = ("prepare (data + Elo + features)", "simulate (Monte Carlo)")


def trace_events(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_cli_on_cpu_writes_a_trace_with_the_phases(tmp_path):
    """`python -m monte_carlo_gp_torch ... --device cpu --trace DIR` exits 0,
    writes one `*.pt.trace.json` into DIR holding each phase as a named range
    and the plain version's CPU operators, and prints its path."""
    out = tmp_path / "trace"
    proc = subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch", *WEEKEND, "--trace", str(out),
         "--cache-dir", str(tmp_path / "cache")],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Prediction complete!" in proc.stdout
    (path,) = out.glob("*.pt.trace.json")
    assert f"Trace: {path} (0 device events)" in proc.stdout
    events = trace_events(path)
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(PHASES) <= ranges
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_traced_weekend_is_bitwise_the_untraced_one(tmp_path, capsys):
    """The same seed gives bitwise the same result with and without
    `--trace`."""
    traced, timers = run([*WEEKEND, "--trace", str(tmp_path / "t"),
                          "--cache-dir", str(tmp_path / "a")])
    untraced, _ = run([*WEEKEND, "--cache-dir", str(tmp_path / "b")])
    assert traced["full_distributions"] == untraced["full_distributions"]
    assert traced["pole_probabilities"] == untraced["pole_probabilities"]
    assert set(PHASES) <= set(timers.totals)
    assert len(list((tmp_path / "t").glob("*.pt.trace.json"))) == 1
    assert not (tmp_path / "b").joinpath("t").exists()
    assert "Trace: " in capsys.readouterr().out


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(log_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda *a, **k: pytest.fail("trace(None) started the profiler"))
    with trace(log_dir, "cuda") as t:
        x = torch.ones(3).sum()
    assert t is None and float(x) == 3.0
    assert list(tmp_path.iterdir()) == []


class StandInProfile:
    """A stand-in for `torch.profiler.profile` that records the activities
    it was asked for and returns the events it was given."""

    def __init__(self, events, asked):
        self._events = events
        self._asked = asked

    def __call__(self, activities):
        self._asked.extend(activities)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events

    def key_averages(self):
        return []

    def export_chrome_trace(self, path, use_python_export=False):
        Path(path).write_text('{"traceEvents": []}')


def event(device_type):
    return SimpleNamespace(device_type=device_type, key="x")


def test_cuda_trace_with_no_device_event_raises_and_writes_nothing(monkeypatch, tmp_path):
    """A CUDA run whose trace recorded no device event (CUPTI saw nothing)
    raises instead of writing a CPU-only trace that looks whole."""
    asked = []
    cpu = torch.autograd.DeviceType.CPU
    monkeypatch.setattr(torch.profiler, "profile", StandInProfile([event(cpu)] * 3, asked))
    with pytest.raises(TraceError, match="no device event"):
        with trace(str(tmp_path / "t"), torch.device("cuda", 0)):
            pass
    assert asked == [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    assert not (tmp_path / "t").exists()


def test_cuda_trace_with_device_events_is_written(monkeypatch, tmp_path):
    asked = []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    monkeypatch.setattr(torch.profiler, "profile",
                        StandInProfile([event(cpu), event(cuda), event(cuda)], asked))
    with trace(str(tmp_path / "t"), "cuda") as t:
        pass
    assert t.device_events == 2 and t.path.parent == tmp_path / "t" and t.path.exists()
    assert t.path.name.endswith(".pt.trace.json")
    assert torch.profiler.ProfilerActivity.CUDA in asked


def test_a_block_that_raises_writes_no_trace(tmp_path):
    with pytest.raises(ValueError):
        with trace(str(tmp_path / "t"), "cpu") as t:
            raise ValueError("no practice data")
    assert t.path is None and not (tmp_path / "t").exists()


def test_device_times_us_and_device_events_read_a_profile():
    """`device_times_us` (which `profile_kernel` and `chip_smoke.py` read
    device time with) sums self device time over the device's own work, all
    of it and the named kernel's: the CPU operator and the phase range (on
    the CPU and its copy on the device's timeline) that a kernel's time is
    also attributed to do not count it twice. `device_events` counts the
    device's work."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def avg(key, us, device_type, is_user_annotation=False):
        return SimpleNamespace(key=key, self_device_time_total=us, device_type=device_type,
                               is_user_annotation=is_user_annotation)

    prof = SimpleNamespace(
        key_averages=lambda: [
            avg("void race_kernel<1>(...)", 60_000.0, cuda),
            avg("simulate (Monte Carlo)", 60_000.0, cpu, True),
            avg("simulate (Monte Carlo)", 60_100.0, cuda, True),
            avg("void season_kernel<1>(...)", 300.0, cuda),
            avg("Memcpy DtoH (Device -> Pageable)", 5.0, cuda),
            avg("aten::copy_", 5.0, cpu),
            avg("aten::empty", 0.0, cpu),
        ],
        events=lambda: [event(cuda), event(cpu), event(cuda),
                        SimpleNamespace(device_type=cuda, is_user_annotation=True)],
    )
    assert profiling.device_times_us(prof) == (60_000.0, 60_305.0)
    assert profiling.device_times_us(prof, "season_kernel") == (300.0, 60_305.0)
    assert profiling.device_time_by_name(prof, top=2) == [
        ("void race_kernel<1>(...)", 60_000.0), ("void season_kernel<1>(...)", 300.0)]
    assert profiling.device_events(prof) == 2
    from monte_carlo_gp_torch import profile_kernel

    assert not hasattr(profile_kernel, "device_times_us")  # one reader, not a copy
