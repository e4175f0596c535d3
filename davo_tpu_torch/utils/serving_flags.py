"""Fused-serving flags validated on the card (BENCH_FLAGS_torch.json).

`promote` writes the file only after a fused serving candidate ran on a
GPU (`bench.serving_probe.probe`), matched the unfused `davo-fast`
baseline's poses within tolerance and beat its frames/s by more than
2 %; `load_validated_flags` is the gate `infer --serving-flags` reads:
the file exists, was validated on a GPU and fingerprints the installed
serving code. The JAX package keeps its own file (BENCH_FLAGS.json,
validated on a TPU against its own fingerprint), and neither gate reads
the other's.

The file carries no compiler options: the JAX package's winners may need
per-computation PJRT options, a CUDA kernel here takes none. It carries
the card (`nvidia-smi`'s name and power limit) beside its frames/s.
"""

from __future__ import annotations

import hashlib
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGS = os.path.join(ROOT, "BENCH_FLAGS_torch.json")

# The files whose content defines fused serving: probe results and
# promoted flags measured against different content are stale.
FINGERPRINT_FILES = (
    "davo_tpu_torch/kernels/costvol.py",
    "davo_tpu_torch/kernels/rowconv.py",
    "davo_tpu_torch/kernels/cuda_build.py",
    "davo_tpu_torch/kernels/resize.py",
    "davo_tpu_torch/csrc/costvol.cu",
    "davo_tpu_torch/csrc/rowconv.cu",
    "davo_tpu_torch/csrc/conv_mma.cuh",
    "davo_tpu_torch/csrc/costvol_tile.cuh",
    "davo_tpu_torch/csrc/common.cuh",
    "davo_tpu_torch/core/warp.py",
    "davo_tpu_torch/models/common.py",
    "davo_tpu_torch/models/flownet.py",
    "davo_tpu_torch/models/attention.py",
    "davo_tpu_torch/models/posenet.py",
    "davo_tpu_torch/models/davo.py",
    "davo_tpu_torch/models/presets.py",
    "davo_tpu_torch/config.py",
)

BASELINE = "davo-fast (slices baseline)"
# Poses are bf16-computed on both paths: gate at 2 % of the baseline's
# largest output, plus an absolute floor for near-zero outputs.
REL_TOL = 0.02
ABS_FLOOR = 1e-5
MIN_SPEEDUP = 1.02


def fingerprint(root: str = ROOT) -> str:
    """sha256 over FINGERPRINT_FILES under `root`, 16 hex digits."""
    h = hashlib.sha256()
    for rel in FINGERPRINT_FILES:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load_validated_flags(path: str | None = None) -> dict:
    """The flags at `path` (default FLAGS) if that file exists, was
    validated on a GPU and fingerprints the current code; else {}."""
    path = path or FLAGS
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        flags = json.load(f)
    if flags.get("validated_on") == "gpu" and flags.get("fingerprint") == fingerprint():
        return flags
    return {}


def promote(results: dict, path: str | None = None) -> dict | None:
    """Write the fastest validated candidate of the probe `results` to
    `path` (default FLAGS), atomically, and return what was written.

    `results` is `serving_probe.probe`'s dict: "_fingerprint", "_card",
    the BASELINE entry and one entry per candidate. A candidate wins when
    it completed, was checked for equality, lies within REL_TOL of the
    baseline's largest output plus ABS_FLOOR, and runs at least
    MIN_SPEEDUP times the baseline's frames/s. Results of other code
    (a stale fingerprint) promote nothing and remove an existing file.
    Returns None when nothing is written."""
    path = path or FLAGS
    fp = fingerprint()
    if results.get("_fingerprint") != fp:
        print("probe results were measured against different serving code (stale fingerprint); refusing to "
              f"promote, and removing any existing {os.path.basename(path)}")
        if os.path.exists(path):
            os.remove(path)
        return None
    base = results.get(BASELINE)
    if not base or base.get("status") != "done":
        print("no completed baseline probe; nothing to do")
        return None
    tol = REL_TOL * base.get("out_absmax", 0.0) + ABS_FLOOR
    best = None
    for tag, r in results.items():
        if (
            isinstance(r, dict)
            and r.get("status") == "done"
            and r.get("base") == "davo-fast"
            and r.get("equality_checked")
            and r.get("maxerr", float("inf")) <= tol
            and r.get("fps", 0.0) >= base["fps"] * MIN_SPEEDUP
            and (best is None or r["fps"] > best[1]["fps"])
        ):
            best = (tag, r)
    if best is None:
        print(f"no candidate beat baseline {base['fps']:.0f} fps within tol={tol:.2e}; "
              f"{os.path.basename(path)} untouched")
        return None
    tag, r = best
    flags = {
        "overrides": {f"model.{k}": v for k, v in r["overrides"].items()},
        "validated_on": "gpu",
        "fingerprint": fp,
        "probe": tag,
        "probe_fps": r["fps"],
        "baseline_fps": base["fps"],
        "maxerr": r["maxerr"],
        "tolerance": tol,
        "card": results.get("_card"),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(flags, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    print(f"{os.path.basename(path)} <- {tag}: {r['fps']:.0f} fps (baseline {base['fps']:.0f}), "
          f"maxerr {r['maxerr']:.2e}")
    return flags
