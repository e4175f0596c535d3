"""Build and load the hand-written CUDA kernels in `davo_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with `ctypes`. Libraries go
to `build/davo_tpu_torch/` under the repository root (ignored by git),
named by the hash of the source and of the headers beside it
(`csrc/*.cuh`), so an edited source or header is rebuilt and an
unchanged one is reused. Everything happens at first use: importing
this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "davo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Loaded libraries by source name, and the compiler's report of each
# build (registers, shared memory, spills) for the run that built it.
_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of davo_tpu_torch are built at "
        "first use and need the CUDA toolkit"
    )


def _build(name: str) -> Path:
    """The library of `csrc/<name>.cu`, compiled unless a current one exists."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_LOG[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu (nvcc exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built if needed)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(_build(name)))
    return _LOADED[name]
