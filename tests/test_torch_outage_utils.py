"""The port's device-outage classifier and probe
(`monte_carlo_gp_torch.utils.outage`), the twin of tests/test_outage_utils.py
against the port's own signatures: the race and season kernels' launch
errors and torch's CUDA runtime errors are outages, an out-of-memory error
and other exceptions are not; the probe runs one tiny op in a killable
subprocess."""

import subprocess

import pytest
import torch

import monte_carlo_gp_torch.utils.outage as outage
from monte_carlo_gp_torch.utils.outage import (
    OUTAGE_MARKERS,
    is_backend_outage,
    probe_backend_once,
)


@pytest.mark.parametrize("exc", [
    RuntimeError("race kernel launch failed: CUDA error 700"),
    RuntimeError("season kernel launch failed: CUDA error 719"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure\nCUDA kernel errors might be "
                 "asynchronously reported"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["race_kernel", "season_kernel", "illegal_address", "launch_failure", "accelerator_error"])
def test_classifier_matches_device_failures(exc):
    assert is_backend_outage(exc)


@pytest.mark.parametrize("exc", [
    ValueError("CUDA error"),  # wrong type
    RuntimeError("shape mismatch"),
    KeyError("race kernel launch failed"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB (CUDA error)"),
    *(Exception(marker) for marker in OUTAGE_MARKERS),  # not a RuntimeError
], ids=["value_error", "other_runtime_error", "key_error", "out_of_memory",
        *(f"plain_exception_{i}" for i in range(len(OUTAGE_MARKERS)))])
def test_classifier_rejects_non_outages(exc):
    assert not is_backend_outage(exc)


def test_probe_success_on_cpu():
    ok, dt, detail = probe_backend_once(device_type="cpu", timeout_s=120)
    assert ok, detail
    assert detail.startswith("cpu")
    assert dt > 0


def test_probe_of_cuda_fails_without_a_device(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    ok, _, detail = probe_backend_once(device_type="cuda", timeout_s=120)
    assert not ok and detail == "no CUDA device"


def test_probe_timeout_returns_false(monkeypatch):
    def fake_run(*a, **k):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=k["timeout"])

    monkeypatch.setattr(outage.subprocess, "run", fake_run)
    ok, dt, detail = probe_backend_once(timeout_s=1)
    assert not ok and detail == "timeout"


def test_probe_child_failure_returns_last_stderr(monkeypatch):
    def fake_run(*a, **k):
        return subprocess.CompletedProcess(
            a[0], 1, stdout="", stderr="trace\nRuntimeError: CUDA error: unknown error\n"
        )

    monkeypatch.setattr(outage.subprocess, "run", fake_run)
    ok, dt, detail = probe_backend_once(timeout_s=1)
    assert not ok and "CUDA error" in detail
