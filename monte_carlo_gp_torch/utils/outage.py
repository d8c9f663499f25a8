"""Device-outage classification and probing for the serving layer.

A failed launch of a race kernel, or any CUDA runtime error, can leave this
process's CUDA context unusable: a sticky error (an illegal address, a
failed launch) makes every later call on the device fail too. The
classifier below names those failures; the probe runs one tiny op on a
device type in a killable subprocess, which says whether the card itself
answers. A fresh process can pass while this process's context stays
broken, so the service also checks its own device in-process before it
resumes (`serve.PredictionService`).
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

# The wrappers' launch errors (ops/race_kernel.py, race_counts and
# season_counts) and torch's CUDA runtime errors ("CUDA error: ...").
OUTAGE_MARKERS = ("race kernel launch failed", "season kernel launch failed", "CUDA error")


def is_backend_outage(exc: BaseException) -> bool:
    """True when `exc` is a failure of the device: a race or season
    kernel's launch error, `torch.AcceleratorError` where torch has it, or
    a RuntimeError whose message carries "CUDA error". An out-of-memory
    error is not an outage."""
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    return any(marker in msg for marker in OUTAGE_MARKERS)


def probe_backend_once(
    device_type: str = "cuda", timeout_s: float = 20.0
) -> tuple[bool, float, str]:
    """One tiny op on `device_type` ("cuda" or "cpu") in a killable
    subprocess. Returns (ok, seconds, detail): detail is the child's stdout
    on success, its last stderr line (or 'timeout') otherwise."""
    snippet = (
        "import sys, torch;"
        f"dev = torch.device({device_type!r});"
        "ok = dev.type != 'cuda' or torch.cuda.is_available();"
        "ok or sys.exit('no CUDA device');"
        "v = float(torch.ones(8, device=dev).sum());"
        "print(dev.type, v)"
    )
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-c", snippet],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return False, time.perf_counter() - t0, "timeout"
    except OSError as e:
        return False, time.perf_counter() - t0, str(e)
    dt = time.perf_counter() - t0
    if out.returncode == 0:
        return True, dt, out.stdout.strip()
    tail = (out.stderr or "").strip().splitlines()
    return False, dt, (tail[-1] if tail else f"rc={out.returncode}")
