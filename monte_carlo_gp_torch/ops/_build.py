"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled with nvcc for sm_90a (Hopper) into
`build/kernels/` at the repository root (git-ignored), under a name keyed
on a hash of its sources and flags, so a library built from older sources
is never loaded. Libraries expose a plain C interface and are bound with
ctypes. A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # keep a*b+c as a multiply and an add, as the plain version computes it
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels are built at first use"
    )


def library_path(name: str, sources: list[str], src_dir: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sources:
        h.update((src_dir / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_cuda_library(name: str, sources: list[str], src_dir: Path = CSRC_DIR) -> Path:
    """Path of the built library for `sources` (file names under `src_dir`,
    by default the package's csrc/), compiling it if it is not there yet.
    The compiler's report (registers, spills) is kept beside it as
    `<library>.log`."""
    out = library_path(name, sources, src_dir)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(src_dir / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
