"""ctypes binding of the C++ KITTI odometry evaluator (port of
davo_tpu.eval.devkit).

Compiled with g++ from `tools/kitti_devkit/evaluate_odometry.cc` at first
use into `build/davo_tpu_torch/` (ignored by git), named by the hash of
the source and the flags, written under a temporary name and then
renamed, so concurrent first uses never load a half-written library.
The C++ and the Python evaluator (`eval/metrics.py`) cross-check each
other: the reference's only native component was this evaluator
(SURVEY.md R13). A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "tools" / "kitti_devkit" / "evaluate_odometry.cc"
BUILD_DIR = _REPO / "build" / "davo_tpu_torch"
CXX_FLAGS = ("-O2", "-Wall", "-shared", "-fPIC")
_lib = None


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    target = BUILD_DIR / f"libkitti_eval-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"KITTI devkit build failed (g++ exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.kitti_evaluate.restype = ctypes.c_int
        lib.kitti_evaluate.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    return _lib


def kitti_seg_errors_cpp(gt: np.ndarray, pred: np.ndarray, step: int = 10) -> dict:
    """C++ devkit equivalent of `metrics.kitti_seg_errors` (means only)."""
    lib = _load()
    gt64 = np.ascontiguousarray(gt, dtype=np.float64)
    pred64 = np.ascontiguousarray(pred, dtype=np.float64)
    if gt64.shape != pred64.shape or gt64.shape[1:] != (4, 4):
        raise ValueError(f"need two (N, 4, 4) trajectories, got {gt64.shape} and {pred64.shape}")
    t_err = ctypes.c_double()
    r_err = ctypes.c_double()
    count = lib.kitti_evaluate(
        gt64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pred64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(gt64),
        step,
        ctypes.byref(t_err),
        ctypes.byref(r_err),
    )
    if count == 0:
        return {"t_err_pct": float("nan"), "r_err_deg_per_100m": float("nan"), "n_segments": 0}
    return {
        "t_err_pct": 100.0 * t_err.value,
        "r_err_deg_per_100m": np.degrees(r_err.value) * 100.0,
        "n_segments": count,
    }
