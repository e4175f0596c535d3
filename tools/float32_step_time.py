"""Time the unfused `davo` train step in float32 on one NVIDIA GPU, with
the port of a given checkout: chip_smoke.py phase 10's protocol (128x416,
synthetic worlds, TrainConfig's defaults, CUDA events over 10 steps after
3 warm-up steps) at B=4 and B=64, compute dtype float32. Prints one JSON
line: the card's name and power limit, the checkout, each batch's median
and all ten times, and the float32 convolutions' route (the count of
`F.conv2d` calls on the card in one step, and, where the checkout has it,
`kernels/conv_f32.py`'s launches in that step).

To compare two checkouts on one card, run it on each in turns, the
parent unpacked with `git archive` into a directory `.gitignore` lists:

    python3 tools/float32_step_time.py --root build/parent   # then . . and build/parent

`--profile` adds where the host's time goes in 3 B=4 steps (cProfile,
the card synchronized before and after): the wall ms a step under the
profiler and the functions of most own time, each with its calls and
own and cumulative ms a step. The profiler slows every Python call, so
read its shares, not its totals.

The checkout's kernels are built (into its own build/) at first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _host_profile(torch, step_fn, state, batch, steps: int, top: int = 30) -> dict:
    """cProfile of `steps` train steps: wall ms a step, and the `top`
    functions by own time with calls, own ms and cumulative ms a step."""
    import cProfile
    import pstats
    import time

    profiler = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profiler.enable()
    for _ in range(steps):
        step_fn(state, batch)
    torch.cuda.synchronize()
    profiler.disable()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    stats = pstats.Stats(profiler).stats
    def listed(rows):
        return [{"function": f"{Path(file).name}:{line}({name})", "calls_per_step": calls / steps,
                 "own_ms_per_step": own * 1e3 / steps, "cumulative_ms_per_step": cum * 1e3 / steps}
                for (file, line, name), (_, calls, own, cum, _) in rows]

    kernels = [kv for kv in stats.items() if "davo_tpu_torch/kernels" in kv[0][0].replace("\\", "/")]
    return {"wall_ms_per_step": wall,
            "functions": listed(sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]),
            "kernel_modules_by_cumulative": listed(sorted(kernels, key=lambda kv: -kv[1][3])[:top])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="the checkout whose port and chip_smoke.py to time (default: this one)")
    parser.add_argument("--profile", action="store_true", help="also profile the host over 3 B=4 steps")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from davo_tpu_torch import exact_f32
    from davo_tpu_torch.data.snippets import MultiSourceDataset
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models import presets

    if not torch.cuda.is_available():
        print("float32_step_time: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    exact_f32()
    worlds = [SyntheticSequence(n_frames=8, height=128, width=416, seed=i) for i in range(2)]
    batch4 = next(MultiSourceDataset(worlds, batch_size=4, with_seg=True, augment=True, seed=0).batches(steps=1))
    base = presets.with_overrides("davo", compute_dtype="float32")
    out = {"card": card, "root": str(root), "preset": "davo, 128x416, float32, unfused"}
    for B in (4, 64):
        cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=B))
        torch.cuda.empty_cache()
        state, step_fn, batch, times, _ = cs._time_steps(torch, cfg, batch4, B)
        calls, real = [0], F.conv2d

        def counted(x, *a, **k):
            calls[0] += x.is_cuda and x.dtype == torch.float32
            return real(x, *a, **k)

        try:
            from davo_tpu_torch.kernels import conv_f32
        except ImportError:
            conv_f32 = None
        if conv_f32 is not None:
            conv_f32.reset_counts()
        F.conv2d = counted
        try:
            step_fn(state, batch)
            torch.cuda.synchronize()
        finally:
            F.conv2d = real
        out[f"B={B}"] = {"step_ms_median": statistics.median(times), "step_ms": times,
                         "float32_conv2d_calls_per_step": calls[0],
                         "conv_f32_launches_per_step": None if conv_f32 is None else dict(conv_f32.device_launches)}
        if args.profile and B == 4:
            out["host_profile_B=4"] = _host_profile(torch, step_fn, state, batch, steps=3)
        del state, step_fn, batch
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
