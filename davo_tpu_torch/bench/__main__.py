"""Flagship VO inference throughput on the GPU: the port's bench.py.

    python -m davo_tpu_torch.bench [--device cpu]

Prints ONE JSON line on stdout, with bench.py's keys: {"metric":
"pose_infer_frames_per_s", "value", "unit", "vs_baseline", "median",
"spread_pct", "loops", "davo_preset_fps"}. The metric is frames/s of
streaming pose inference (the full forward: flow + attention + pose) of
`davo-fast` at B=256, 128x416, inputs on the device: the best of LOOPS
loops of ITERS chained forwards after WARMUP, with the median and the
spread of the loops; `davo_preset_fps` is the paper-parity `davo` preset
in the same run (3 loops). Weights are random, from seed 0.

Two departures from bench.py: there is no BENCH_FLAGS.json gate (it
applies only to flags validated on a TPU), and a failure of the `davo`
side measurement is not swallowed: it fails the run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# bench.py's placeholder for the reference DAVO's single-GPU streaming
# inference (TF1 on a GTX-1080-class card, ~15 fps); see BASELINE.md.
BASELINE_FPS = 15.0
BATCH = 256
WARMUP = 2
ITERS = 32
LOOPS = 5
PARITY_LOOPS = 3


def _loop_seconds(model, inputs, warmup, iters, loops) -> list[float]:
    """Seconds of each of `loops` loops of `iters` chained forwards, each
    loop ended by a synchronise, after `warmup` forwards."""
    device = inputs[0].device
    with torch.inference_mode():
        for _ in range(warmup):
            model(*inputs[:2], seg=inputs[2])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times = []
        for _ in range(loops):
            t0 = time.perf_counter()
            for _ in range(iters):
                poses = model(*inputs[:2], seg=inputs[2])["poses"]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
    if not torch.isfinite(poses).all():
        raise RuntimeError("the bench forward gave non-finite poses")
    return times


def main(device=None, preset: str = "davo-fast", parity_preset: str = "davo", batch: int = BATCH,
         warmup: int = WARMUP, iters: int = ITERS, loops: int = LOOPS) -> dict:
    """Measure, print the JSON line, and return it as a dict."""
    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    device = resolve_device(device)
    cfg = presets.get(preset).model
    rng = np.random.default_rng(0)
    H, W = cfg.img_height, cfg.img_width
    inputs = (
        torch.from_numpy(rng.uniform(size=(batch, H, W, 3)).astype(np.float32)).to(device),
        torch.from_numpy(rng.uniform(size=(batch, 1, H, W, 3)).astype(np.float32)).to(device),
        torch.from_numpy(rng.integers(0, 19, (batch, H, W)).astype(np.int32)).to(device),
    )
    model = DavoModel(cfg, device=device, seed=0).eval()
    times = _loop_seconds(model, inputs, warmup, iters, loops)
    best = min(times)
    med = float(np.median(times))
    fps = batch * iters / best
    out = {
        "metric": "pose_infer_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "median": round(batch * iters / med, 2),
        "spread_pct": round(100.0 * (max(times) - best) / best, 1),
        "loops": loops,
    }
    del model
    pcfg = presets.get(parity_preset).model
    if (pcfg.img_height, pcfg.img_width) != (H, W):
        raise ValueError(f"{parity_preset!r} is {pcfg.img_height}x{pcfg.img_width}, {preset!r} {H}x{W}")
    parity = DavoModel(pcfg, device=device, seed=0).eval()
    ptimes = _loop_seconds(parity, inputs, warmup, iters, PARITY_LOOPS)
    out["davo_preset_fps"] = round(batch * iters / min(ptimes), 2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m davo_tpu_torch.bench")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU; 'cpu' to run on the CPU)")
    main(parser.parse_args().device)
