"""Throughput benchmarks for inference and training steps (port of
davo_tpu.bench.throughput): the reference's inputs, protocol and result
keys, on the device the caller names (the GPU unless device="cpu")."""

from __future__ import annotations

import time

import numpy as np
import torch

from davo_tpu_torch import resolve_device
from davo_tpu_torch.config import Config
from davo_tpu_torch.utils.profiling import block_until_ready, timed


def _dummy_inputs(cfg: Config, batch: int, device: torch.device) -> dict:
    rng = np.random.default_rng(0)
    H, W = cfg.model.img_height, cfg.model.img_width
    data = {
        "target": rng.uniform(size=(batch, H, W, 3)).astype(np.float32),
        "sources": rng.uniform(size=(batch, 1, H, W, 3)).astype(np.float32),
    }
    if cfg.model.attention == "flow_seg":
        data["seg"] = rng.integers(0, cfg.model.num_seg_classes, (batch, H, W)).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


def bench_inference(cfg: Config, batch: int = 128, iters: int = 10, device=None) -> dict:
    """Full-model streaming pose inference frames/s."""
    from davo_tpu_torch.models.davo import DavoModel

    device = resolve_device(device)
    model = DavoModel(cfg.model, device=device, seed=0).eval()
    data = _dummy_inputs(cfg, batch, device)

    @torch.inference_mode()
    def infer(target, sources, seg):
        return model(target, sources, seg=seg)["poses"]

    result = timed(infer, data["target"], data["sources"], data.get("seg"), iters=iters)
    return {
        "ms_per_batch": result["ms"],
        "frames_per_s": batch / result["ms"] * 1000.0,
        "batch": batch,
    }


def bench_train_step(cfg: Config, batch: int = 16, iters: int = 5, device=None) -> dict:
    """Train-step steps/s (forward + backward + Adam), the minimum over 3
    loops of `iters` steps after one warm-up step."""
    from davo_tpu_torch.data.snippets import SnippetDataset
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.train.loop import create_state, make_train_step

    device = resolve_device(device)
    seq = SyntheticSequence(
        n_frames=batch + 4,
        height=cfg.model.img_height,
        width=cfg.model.img_width,
    )
    ds = SnippetDataset(
        seq,
        batch_size=batch,
        with_seg=cfg.model.attention == "flow_seg",
        with_gt=True,
    )
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in next(ds.batches(steps=1)).items()}
    state = create_state(cfg, device)
    step = make_train_step(cfg, device)

    state, _ = step(state, b)  # warm-up
    block_until_ready(list(state.model.parameters()))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, b)
        block_until_ready(list(state.model.parameters()))
        times.append((time.perf_counter() - t0) / iters * 1000.0)
    ms = min(times)
    return {
        "ms_per_step": ms,
        "steps_per_s": 1000.0 / ms,
        "frames_per_s": batch * 1000.0 / ms,
        "batch": batch,
    }
