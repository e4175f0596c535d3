"""davo_tpu_torch CLI (the ported subset): infer.

  python -m davo_tpu_torch.cli.main infer --version davo-fast \
      --data synthetic --seq 0 --out poses.txt [--set model.k=v ...]

Runs on the GPU unless `--device cpu`. `--version` selects a preset;
dotted `--set key=value` overrides reach any config field. Checkpoints,
KITTI input and scan-chunked serving are not ported yet and are refused.
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


def cmd_infer(args) -> int:
    refused = []
    if args.ckpt:
        refused.append("--ckpt (checkpoints)")
    if args.data != "synthetic":
        refused.append(f"--data {args.data} (only 'synthetic' is ported)")
    if args.scan_chunks != 1:
        refused.append("--scan-chunks")
    if refused:
        print(
            "infer: not ported to davo_tpu_torch yet: " + ", ".join(refused),
            file=sys.stderr,
        )
        return 2

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="davo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    i.add_argument(
        "--device", default=None,
        help="torch device (default: the GPU; 'cpu' to run on the CPU)",
    )
    i.set_defaults(fn=cmd_infer)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
