"""The serving probe on the card: `davo-fast` unfused against each fused
serving candidate, the results `utils.serving_flags.promote` reads.

    python -m davo_tpu_torch.bench.serving_probe    # on a GPU: probe, print, promote

Every model is `davo-fast` at its preset's size (128x416) with the same
random weights (seed 0) and the same inputs on the card. For each, the
frames/s of the forward: 2 warm-up forwards, then LOOPS loops of `iters`
forwards, each loop timed by CUDA events around it, the models in turns;
"fps" is the median loop's, "fps_best" the best's. Each candidate's poses are held against
the baseline's on one batch ("maxerr", the largest absolute difference).
A candidate that raises is recorded as failed, as the JAX package's
probe records it. There is no CPU path: the probe measures the card.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from davo_tpu_torch.utils import serving_flags

PRESET = "davo-fast"
SERVING_FLAGS = ("fuse_flow_level", "fuse_pose_encoder", "fuse_attention", "fuse_pyramid")
# (tag, model overrides): each serving flag alone, the four together, and
# the fused estimator alone.
CANDIDATES = (
    *((f"{PRESET} ({flag})", {flag: True}) for flag in SERVING_FLAGS),
    (f"{PRESET} (all fused)", dict.fromkeys(SERVING_FLAGS, True)),
    (f"{PRESET} (fuse_estimator)", {"fuse_estimator": True}),
)
WARMUP = 2
LOOPS = 7


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _inputs(cfg, batch: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(11)
    H, W = cfg.img_height, cfg.img_width
    return (torch.rand(batch, H, W, 3, device=device, generator=gen),
            torch.rand(batch, 1, H, W, 3, device=device, generator=gen),
            torch.randint(0, cfg.num_seg_classes, (batch, H, W), device=device, generator=gen))


def _loop_seconds(model, inputs, iters: int) -> float:
    """Seconds of `iters` forwards of `model` on `inputs`, by CUDA events."""
    x, y, s = inputs
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model(x, y, seg=s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def probe(batch: int = 64, iters: int = 10) -> dict:
    """{"_fingerprint", "_card", "_batch", the baseline's entry
    (`serving_flags.BASELINE`), one entry per candidate}: each entry's
    "status", "ms", "fps", "fps_best", "base", "overrides",
    "equality_checked"; the baseline's "out_absmax" (its poses' largest
    magnitude), each candidate's "maxerr" against the baseline's poses.

    The forward is host-bound at this batch, so the models are timed in
    turns: each of LOOPS rounds times one loop of every model, so that
    what else the host does falls on all of them alike."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    if not torch.cuda.is_available():
        raise RuntimeError("the serving probe measures a GPU, and no CUDA device is available")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = presets.get(PRESET).model
    x, y, s = inputs = _inputs(cfg, batch, device)
    models = {serving_flags.BASELINE: DavoModel(cfg, device=device, seed=0).eval()}
    state = models[serving_flags.BASELINE].state_dict()
    results = {
        "_fingerprint": serving_flags.fingerprint(), "_card": card_name(), "_batch": batch,
        serving_flags.BASELINE: {"status": "done", "base": PRESET, "overrides": {}, "equality_checked": False},
    }
    poses = {}
    with torch.inference_mode():
        for tag, overrides in ((serving_flags.BASELINE, {}), *CANDIDATES):
            if tag != serving_flags.BASELINE:
                results[tag] = {"base": PRESET, "overrides": dict(overrides), "equality_checked": True}
            try:
                if tag not in models:
                    models[tag] = DavoModel(presets.with_overrides(PRESET, **overrides).model, device=device,
                                            seed=0).eval()
                    models[tag].load_state_dict(state)
                poses[tag] = models[tag](x, y, seg=s)["poses"].float()
                for _ in range(WARMUP - 1):
                    models[tag](x, y, seg=s)
            except Exception as e:  # a candidate that fails is recorded, as the reference's probe records it
                if tag == serving_flags.BASELINE:
                    raise
                models.pop(tag, None)
                results[tag].update(status="failed", error=f"{type(e).__name__}: {e}"[:1200])
        seconds = {tag: [] for tag in models}
        for _ in range(LOOPS):
            for tag, model in models.items():
                seconds[tag].append(_loop_seconds(model, inputs, iters))
    ref = poses[serving_flags.BASELINE]
    for tag, times in seconds.items():
        results[tag].update(status="done", ms=statistics.median(times) / iters * 1e3,
                            fps=batch * iters / statistics.median(times), fps_best=batch * iters / min(times))
        if tag == serving_flags.BASELINE:
            results[tag]["out_absmax"] = float(ref.abs().max())
        else:
            results[tag]["maxerr"] = float((poses[tag] - ref).abs().max())
    del models, poses
    torch.cuda.empty_cache()
    return results


def main() -> int:
    """Probe, print the results as one JSON line, and promote the winner
    to `serving_flags.FLAGS`."""
    results = probe()
    print(json.dumps(results), flush=True)
    serving_flags.promote(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
