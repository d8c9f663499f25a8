"""ctypes binding for the native C++ reference-semantics oracle
(`native/oracle.cpp`): an independent sequential implementation of the race
rules, used to hold the race kernel's distributions to a tight bound.

The library is built with g++ at first use into `build/native/` at the
repository root (git-ignored), under a name keyed on a hash of the source;
`MCGP_COMPILE_CACHE` moves it as it moves the CUDA libraries
(`ops/_build.build_dir`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.ops._build import build_dir

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "oracle.cpp"
_GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib = None

# Rule mutations of the oracle (native/oracle.cpp, enum Mutation): each drops
# one rule on purpose, so a test can show that its tolerance catches a rule
# fault.
MUT_NONE = 0
MUT_NO_FRONT_ROW_START_CLAMP = 1
MUT_NO_TWO_COMPOUND_RULE = 2


def library_path() -> Path:
    """Where the oracle library of the current source is (or would be) built."""
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir("native") / f"liboracle-{key}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building the native oracle failed:\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.run_oracle_mut.argtypes = [
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f32p, f32p, f32p, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32,
        f32p, f32p, i32p,
        ctypes.c_int32,
        i64p,
    ]
    lib.run_oracle_mut.restype = None
    _lib = lib
    return lib


def run_native_oracle(
    params: SimParams, seed: int, n_sims: int, total_laps: int,
    mutation: int = MUT_NONE,
) -> np.ndarray:
    """(D, D) float64 [driver, position] finish probabilities of `n_sims`
    races from the native oracle (its own RNG stream, seeded by `seed`).
    `mutation` (a MUT_* value) drops one rule on purpose; only the
    mutation-sensitivity checks pass anything but MUT_NONE."""
    lib = _load()
    d = params.n_drivers
    counts = np.zeros((d, d), np.int64)
    f32 = lambda t: np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)
    scalar = lambda t: float(t.item())
    lib.run_oracle_mut(
        ctypes.c_uint64(seed),
        np.int32(n_sims), np.int32(d), np.int32(total_laps),
        f32(params.grid_probs), f32(params.base_pace), f32(params.tire_deg),
        f32(params.variance), f32(params.dnf_rate), f32(params.team_dnf_rate),
        scalar(params.pit_loss), scalar(params.overtake_delta),
        scalar(params.sc_prob), scalar(params.vsc_prob),
        scalar(params.red_flag_prob), scalar(params.drs_delta),
        scalar(params.dirty_air_threshold), scalar(params.dirty_air_penalty),
        np.int32(int(params.track_condition.item())),
        f32(params.compound_pace), f32(params.compound_deg),
        np.ascontiguousarray(params.compound_optimal.cpu().numpy(), np.int32),
        np.int32(mutation),
        counts,
    )
    return counts.astype(np.float64) / n_sims
