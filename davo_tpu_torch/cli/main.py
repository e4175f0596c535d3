"""davo_tpu_torch CLI (the ported subset): train, infer and bench.

  python -m davo_tpu_torch.cli.main train --version davo --data synthetic \
      --steps 1000 [--checkpoint-dir runs/davo] [--set train.k=v ...]
  python -m davo_tpu_torch.cli.main infer --version davo-fast \
      --data synthetic --seq 0 --out poses.txt [--set model.k=v ...]
  python -m davo_tpu_torch.cli.main bench     # python -m davo_tpu_torch.bench

Runs on the GPU unless `--device cpu`. `--version` selects a preset;
dotted `--set key=value` overrides reach any config field. Prepared or
KITTI training data, `--log-dir`, image summaries, inference from
checkpoints, KITTI input and scan-chunked serving are not ported yet and
are refused.
"""

from __future__ import annotations

import argparse
import sys


def _apply_sets(cfg, sets: list[str] | None):
    from davo_tpu_torch.config import apply_overrides

    overrides = {}
    for item in sets or []:
        key, _, value = item.partition("=")
        overrides[key] = value
    return apply_overrides(cfg, overrides)


def _load_sequence(seq: str, cfg, with_seg: bool):
    """Synthetic world: (frames (N,H,W,3) float32, seg or None, gt poses)."""
    import numpy as np

    from davo_tpu_torch.data.synthetic import SyntheticSequence

    H, W = cfg.model.img_height, cfg.model.img_width
    s = SyntheticSequence(n_frames=32, height=H, width=W, seed=int(seq or 0))
    frames = np.stack([s.frame(i) for i in range(len(s))])
    seg = np.stack([s.seg(i) for i in range(len(s))]) if with_seg else None
    return frames, seg, s.poses


def _refuse(cmd: str, refused: list[str]) -> int:
    print(f"{cmd}: not ported to davo_tpu_torch yet: " + ", ".join(refused), file=sys.stderr)
    return 2


def cmd_train(args) -> int:
    import dataclasses

    from davo_tpu_torch.models import presets

    cfg = _apply_sets(presets.get(args.version), args.set)
    if args.steps:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=args.steps))
    refused = []
    if args.data != "synthetic":
        refused.append(f"--data {args.data} (prepared layouts and KITTI roots)")
    if args.log_dir:
        refused.append("--log-dir (metrics and image summaries)")
    if cfg.train.image_every > 0:
        refused.append("train.image_every > 0 (image summaries)")
    if refused:
        return _refuse("train", refused)

    from davo_tpu_torch.train.loop import SERVING_ONLY_MESSAGE, serving_only_flags_set

    if serving_only_flags_set(cfg.model):
        print(SERVING_ONLY_MESSAGE, file=sys.stderr)
        return 1

    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.data.prefetch import PrefetchStats, device_prefetch
    from davo_tpu_torch.data.snippets import MultiSourceDataset
    from davo_tpu_torch.data.synthetic import DriveSequence, SyntheticSequence
    from davo_tpu_torch.train.loop import fit

    device = resolve_device(args.device)
    wcls = {
        "drive": lambda **kw: DriveSequence(**kw),
        "wander": lambda **kw: SyntheticSequence(
            trajectory="wander", rot_amp=0.06, tilt_amp=0.05, **kw
        ),
        "loop": lambda **kw: SyntheticSequence(**kw),
    }[args.world_class]
    worlds = [
        wcls(n_frames=args.world_frames, height=cfg.model.img_height,
             width=cfg.model.img_width, seed=cfg.train.seed + i)
        for i in range(max(args.worlds, 1))
    ]
    ds = MultiSourceDataset(
        worlds,
        batch_size=cfg.train.batch_size,
        with_seg=cfg.model.attention == "flow_seg",
        with_gt=cfg.train.pose_supervision_weight > 0,
        with_flow=cfg.train.flow_supervision_weight > 0,
        # Zoom/crop makes GT translation unobservable: color only when supervised.
        augment="color" if cfg.train.pose_supervision_weight > 0 else True,
        seed=cfg.train.seed,
    )

    def log_fn(step, metrics):
        print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    stats = PrefetchStats()
    fit(
        cfg,
        device_prefetch(ds.batches(steps=cfg.train.max_steps), device, stats=stats),
        checkpoint_dir=args.checkpoint_dir,
        log_fn=log_fn,
        device=device,
    )
    print(f"prefetch: {stats.summary()}", flush=True)
    return 0


def cmd_infer(args) -> int:
    refused = []
    if args.ckpt:
        refused.append("--ckpt (checkpoints)")
    if args.data != "synthetic":
        refused.append(f"--data {args.data} (only 'synthetic' is ported)")
    if args.scan_chunks != 1:
        refused.append("--scan-chunks")
    if refused:
        return _refuse("infer", refused)

    import numpy as np

    from davo_tpu_torch.data.kitti import write_poses_kitti
    from davo_tpu_torch.eval.runner import (
        assemble_trajectory,
        make_pose_apply_fn,
        predict_sequence,
    )
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = _apply_sets(presets.get(args.version), args.set)
    model = DavoModel(cfg.model, device=args.device)
    frames, seg, gt_poses = _load_sequence(
        args.seq, cfg, cfg.model.attention == "flow_seg"
    )
    rels = predict_sequence(
        make_pose_apply_fn(model), frames, seg=seg, batch_size=args.batch_size
    )
    traj = assemble_trajectory(rels, device=args.device)
    write_poses_kitti(args.out, traj)
    if args.gt_out:
        write_poses_kitti(args.gt_out, np.asarray(gt_poses))
    print(f"wrote {len(traj)} poses to {args.out}")
    return 0


def cmd_bench(args) -> int:
    """bench.py's JSON line (`python -m davo_tpu_torch.bench`); --version
    is accepted and ignored, as the reference's `cli bench` does."""
    from davo_tpu_torch.bench.__main__ import main as bench_main

    bench_main(args.device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="davo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: the GPU; 'cpu' to run on the CPU)"

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--version", default="davo")
    t.add_argument("--data", default="synthetic", help="only 'synthetic' is ported")
    t.add_argument("--world-class", default="loop", choices=("loop", "wander", "drive"))
    t.add_argument("--worlds", type=int, default=16, help="number of synthetic train worlds")
    t.add_argument("--world-frames", type=int, default=24, help="frames per train world")
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--log-dir", default=None, help="not ported yet (refused)")
    t.add_argument("--set", action="append", help="dotted override k=v")
    t.add_argument("--device", default=None, help=device_help)
    t.set_defaults(fn=cmd_train)
    i = sub.add_parser("infer", help="predict a trajectory")
    i.add_argument("--version", default="davo")
    i.add_argument("--data", default="synthetic")
    i.add_argument("--seq", default="09")
    i.add_argument("--ckpt", default=None, help="not ported yet (refused)")
    i.add_argument("--out", required=True)
    i.add_argument(
        "--gt-out", default=None,
        help="also write the sequence's GT trajectory (KITTI format)",
    )
    i.add_argument("--batch-size", type=int, default=32)
    i.add_argument(
        "--scan-chunks", type=int, default=1, help="not ported yet (only 1)"
    )
    i.add_argument("--set", action="append", help="dotted override k=v")
    i.add_argument("--device", default=None, help=device_help)
    i.set_defaults(fn=cmd_infer)
    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("--version", default="davo", help="ignored, as in the reference")
    b.add_argument("--device", default=None, help=device_help)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
