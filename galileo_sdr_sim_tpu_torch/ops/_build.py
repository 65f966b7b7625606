"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `_kernels_build/lib<name>_<hash>.so` inside the package, keyed on a
hash of the source and the flags, then loaded with `ctypes`.  No PyTorch
headers are compiled, so a build takes seconds and needs no `ninja`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_kernels_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of galileo_sdr_sim_tpu_torch are built from source at first use"
    )


def build(name: str, extra_flags: tuple[str, ...] = ()) -> Built:
    """Compile csrc/<name>.cu with `extra_flags` unless a library built
    from the same source and flags exists."""
    src = CSRC / f"{name}.cu"
    flags = (*ARCH_FLAGS, *BASE_FLAGS, *extra_flags)
    digest = hashlib.sha256(src.read_bytes() + "\0".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *flags, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return Built(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


def load(built: Built) -> ctypes.CDLL:
    return ctypes.CDLL(str(built.path))
