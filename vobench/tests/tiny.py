"""A tiny benchmark layout for the CPU tests: the real cells' kinds at
the program's `tiny` sizes (48x64, narrow widths), in bf16 as the
benchmark's configurations, in a directory of their own."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from vobench.harness import BENCH_DIR, Layout

TRAIN_KEYS_DROPPED = ("batch_size", "max_steps", "checkpoint_every", "log_every", "image_every", "seed")


def model_dict(**over) -> dict:
    from davo_tpu_torch.models import presets

    d = dataclasses.asdict(presets.get("tiny").model)
    d.update({"compute_dtype": "bfloat16", **over})
    return d


def train_dict() -> dict:
    from davo_tpu_torch.models import presets

    d = dataclasses.asdict(presets.get("tiny").train)
    for k in TRAIN_KEYS_DROPPED:
        d.pop(k)
    d["warp_gather"] = "banded"
    return d


def write_layout(root: Path, limits: dict | None = None) -> Layout:
    """BENCHMARK.json, configs, traffic and limits for three tiny cells,
    `tiny-fast.serve` (the four serving flags), `tiny.serve` and
    `tiny.train`, under `root`; readers from the benchmark's own folder."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "traffic").mkdir(exist_ok=True)
    (root / "limits").mkdir(exist_ok=True)
    flags = dict(fuse_flow_level=True, fuse_pose_encoder=True, fuse_attention=True, fuse_pyramid=True)
    config = {"name": "tiny", "preset": "tiny", "model": model_dict(), "train": train_dict()}
    (root / "configs" / "tiny.json").write_text(json.dumps(config))
    fast = {"name": "tiny-fast", "preset": "tiny", "model": model_dict(**flags)}
    (root / "configs" / "tiny-fast.json").write_text(json.dumps(fast))
    (root / "traffic" / "serve-tiny.json").write_text(json.dumps(
        {"kind": "serve", "batch": 4, "frames": 11, "pan_px": 1.0, "warmup": 1, "capture": 2,
         "profile_from": 1, "profile_batches": 2}))
    (root / "traffic" / "train-tiny.json").write_text(json.dumps(
        {"kind": "train", "batch": 4, "pool_frames": 14, "pan_px": 1.0, "warmup": 3, "checked": 3,
         "profile_from": 0, "profile_steps": 1}))
    # The tiny cells' limits, from CPU readings at these sizes (seeds 5, 77,
    # 2**31 + 12345): the program in bf16 reads pose 0.003-0.0061, flow
    # 0.0094-0.0189, attn 0.0002-0.0006; loss 0.0014-0.0097, grad
    # 0.043-0.187, change 0.021-0.040 (the first layers' gradients are
    # small leaves at these widths).
    serve_limits = {"pose_gap": 0.01, "flow_gap": 0.05, "attn_gap": 0.002}
    train_limits = {"loss_gap": 0.03, "grad_gap": 0.3, "change_gap": 0.06}
    if limits:
        serve_limits.update({k: v for k, v in limits.items() if k in serve_limits})
        train_limits.update({k: v for k, v in limits.items() if k in train_limits})
    (root / "limits" / "tiny.serve.json").write_text(json.dumps(serve_limits))
    (root / "limits" / "tiny-fast.serve.json").write_text(json.dumps(serve_limits))
    (root / "limits" / "tiny.train.json").write_text(json.dumps(train_limits))
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tiny", "file": f"configs/{n}.json", "reduced": [], "why": "tests"}
                        for n in ("tiny", "tiny-fast")]
    bench["workloads"] = [
        {"name": "tiny-fast.serve", "config": "tiny-fast", "traffic": "serve-tiny", "chips": 1, "why": "tests"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "serve-tiny", "chips": 1, "why": "tests"},
        {"name": "tiny.train", "config": "tiny", "traffic": "train-tiny", "chips": 1, "why": "tests"},
    ]
    renamed = {"davo-fused.serve-b256": "tiny-fast.serve", "davo.serve-b256": "tiny.serve",
               "davo.train-b64": "tiny.train"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(benchmark=root / "BENCHMARK.json", root=root, traffic=root / "traffic",
                  limits=root / "limits", metrics=BENCH_DIR / "metrics")
