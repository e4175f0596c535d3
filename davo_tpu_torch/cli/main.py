"""davo_tpu_torch CLI: train, infer, depth, eval, eval-depth, ba,
export, bench, prep and train-seg.

  python -m davo_tpu_torch.cli.main train --version davo --data synthetic \
      --steps 1000 [--checkpoint-dir runs/davo] [--log-dir logs/davo] \
      [--set train.k=v ...]
  python -m davo_tpu_torch.cli.main prep --dataset kitti_odom --root /kitti \
      --out /prepared [--write-seg --seg-ckpt runs/seg]
  python -m davo_tpu_torch.cli.main train-seg --checkpoint-dir runs/seg
  python -m davo_tpu_torch.cli.main train --version davo --data /prepared \
      --loader native --steps 1000 --log-dir logs/davo
  python -m davo_tpu_torch.cli.main infer --version davo --data /kitti --seq 09 \
      --ckpt runs/davo --out poses.txt [--tum poses.tum] [--gt-out gt.txt] \
      [--scan-chunks 4]
  python -m davo_tpu_torch.cli.main depth --version davo --seq 1 \
      --ckpt runs/davo --out depth/
  python -m davo_tpu_torch.cli.main eval --gt gt.txt --pred poses.txt --devkit
  python -m davo_tpu_torch.cli.main eval-depth --depth-dir depth/ --seq 1
  python -m davo_tpu_torch.cli.main ba --version davo --seq 1 --ckpt runs/davo \
      --pred poses.txt --depth-dir depth/ --out refined.txt
  python -m davo_tpu_torch.cli.main export --version davo-fast --out pose.pt2 \
      [--ckpt runs/davo] [--batch-size 128]
  python -m davo_tpu_torch.cli.main bench     # python -m davo_tpu_torch.bench

`--data` is "synthetic", a prepared tree (a directory with train.txt,
`prep`'s output) or a KITTI odometry root. train, train-seg, infer, depth,
ba, export and `prep --write-seg` run on the GPU unless `--device cpu`; eval,
eval-depth and prep's resizing are host work. `--version` selects a
preset; dotted `--set key=value` overrides reach any config field.
`--ckpt` serves the newest checkpoint that `train --checkpoint-dir`
wrote (`tools/orbax_to_torch.py` converts the reference's); a
`pose_head=geo_hybrid` model gets the sequence's intrinsics in `infer`
and `depth`. `infer --serving-flags` applies the fused-serving flags
that the serving probe validated on the card for this code
(BENCH_FLAGS_torch.json, `utils/serving_flags.py`; no compiler options,
as a CUDA kernel takes none) or, without them, serves the plain config.
`export --platforms` is refused: a torch.export program has no use for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _apply_sets(cfg, sets: list[str] | None):
    from davo_tpu_torch.config import apply_overrides

    overrides = {}
    for item in sets or []:
        key, _, value = item.partition("=")
        overrides[key] = value
    return apply_overrides(cfg, overrides)


def _world(seq: str, cfg):
    """The CLI's synthetic world for `--seq`: 32 frames at the preset's size."""
    from davo_tpu_torch.data.synthetic import SyntheticSequence

    return SyntheticSequence(
        n_frames=32, height=cfg.model.img_height, width=cfg.model.img_width, seed=int(seq or 0)
    )


def _kitti_seg_missing(where: str) -> None:
    print(
        f"{where} has no seg/ label maps: the flow_seg model runs without "
        "region weights, as the reference does from a KITTI root",
        file=sys.stderr,
    )


def _load_sequence(data: str, seq: str, cfg, with_seg: bool):
    """(frames (N,H,W,3) float32, seg or None, gt poses or None, K) of the
    synthetic world `seq` or of sequence `seq` of a KITTI root. A KITTI
    sequence's seg/ label maps are returned when `with_seg` (the
    reference returns none: ROADMAP Queue 3)."""
    import numpy as np

    if data == "synthetic":
        s = _world(seq, cfg)
        frames = np.stack([s.frame(i) for i in range(len(s))])
        seg = np.stack([s.seg(i) for i in range(len(s))]) if with_seg else None
        return frames, seg, s.poses, s.K
    from davo_tpu_torch.data.imageio import image_info
    from davo_tpu_torch.data.kitti import KittiOdometry

    H, W = cfg.model.img_height, cfg.model.img_width
    ko = KittiOdometry(data, seq)
    frames = np.stack([ko.load_frame(i, H, W) for i in range(len(ko))])
    seg = None
    if with_seg and ko.seg_dir is not None:
        seg = np.stack([ko.load_seg(i, H, W) for i in range(len(ko))])
    elif with_seg:
        _kitti_seg_missing(f"{data} sequence {seq}")
    return frames, seg, ko.gt_poses, ko.scaled_intrinsics(H, W, image_info(ko.frame_path(0))[:2])


class _PreparedWrapper:
    """PreparedSnippets with the `batches(steps=N)` interface of the
    other datasets."""

    def __init__(self, prepared, batch_size: int):
        self.prepared = prepared
        self.batch_size = batch_size

    def batches(self, steps=None):
        return self.prepared.batches(self.batch_size, steps=steps)


def _prepared_dataset(args, cfg):
    """The prepared tree's reader (`--loader`), or an exit code."""
    from davo_tpu_torch.data.prep import PreparedSnippets

    prepared = PreparedSnippets(args.data, seed=cfg.train.seed)
    flow_seg = cfg.model.attention == "flow_seg"
    supervised = cfg.train.pose_supervision_weight > 0
    if flow_seg and not prepared.has_seg:
        print(
            "prepared layout has no *_seg.png maps (re-run prep with a seg/ dir "
            "in the source tree, or prep --write-seg); use --version flow or "
            "train from a KITTI root", file=sys.stderr,
        )
        return 1
    if supervised and not prepared.has_gt:
        print(
            "pose_supervision_weight > 0 but the prepared layout has no "
            "*_pose.txt GT (re-run prep from a source with poses, or train "
            "unsupervised)", file=sys.stderr,
        )
        return 1
    # Only decode and ship the lanes the config consumes.
    prepared.has_seg &= flow_seg
    prepared.has_gt &= supervised
    if args.loader in ("auto", "native"):
        # The C++ decode pool overlaps decoding with the train step.
        try:
            from davo_tpu_torch.data.native_loader import NativeSnippetLoader

            ds = NativeSnippetLoader(
                args.data, batch_size=cfg.train.batch_size, seed=cfg.train.seed,
                with_seg=flow_seg, with_gt=supervised,
            )
            print("input pipeline: native C++ loader", flush=True)
            return ds
        except (OSError, RuntimeError, ValueError) as e:
            if args.loader == "native":
                raise
            print(f"native loader unavailable ({e}); python reader", file=sys.stderr)
    print("input pipeline: python reader", flush=True)
    return _PreparedWrapper(prepared, cfg.train.batch_size)


def _restore_model(cfg, ckpt_dir: str, device):
    """The model of the newest checkpoint in `ckpt_dir`, or None (the
    reference's `_restore_model`)."""
    from davo_tpu_torch.train.loop import restore_model

    model = restore_model(cfg, ckpt_dir, device)
    if model is None:
        print(f"no checkpoint found in {ckpt_dir}", file=sys.stderr)
    return model


def _refuse(cmd: str, reason: str) -> int:
    print(f"{cmd}: refused: {reason}", file=sys.stderr)
    return 2


def cmd_train(args) -> int:
    import dataclasses

    from davo_tpu_torch.models import presets

    cfg = _apply_sets(presets.get(args.version), args.set)
    if args.steps:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=args.steps))

    from davo_tpu_torch.train.loop import SERVING_ONLY_MESSAGE, serving_only_flags_set

    if serving_only_flags_set(cfg.model):
        print(SERVING_ONLY_MESSAGE, file=sys.stderr)
        return 1

    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.data.prefetch import PrefetchStats, device_prefetch
    from davo_tpu_torch.data.snippets import (
        MultiSourceDataset,
        SnippetDataset,
        augment_batches,
    )
    from davo_tpu_torch.train.loop import fit

    device = resolve_device(args.device)
    flow_seg = cfg.model.attention == "flow_seg"
    supervised = cfg.train.pose_supervision_weight > 0
    # Zoom/crop makes GT translation unobservable: color only when supervised.
    augment = "color" if supervised else True
    if args.data == "synthetic":
        from davo_tpu_torch.data.synthetic import DriveSequence, SyntheticSequence

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
            worlds, batch_size=cfg.train.batch_size, with_seg=flow_seg, with_gt=supervised,
            with_flow=cfg.train.flow_supervision_weight > 0, augment=augment, seed=cfg.train.seed,
        )
    elif os.path.exists(os.path.join(args.data, "train.txt")):
        ds = _prepared_dataset(args, cfg)
        if isinstance(ds, int):
            return ds
    else:
        from davo_tpu_torch.data.imageio import image_info
        from davo_tpu_torch.data.kitti import TRAIN_SEQS, KittiOdometry
        from davo_tpu_torch.data.snippets import KittiAdapter

        ko = KittiOdometry(args.data, args.seq or TRAIN_SEQS[0])
        ad = KittiAdapter(ko, cfg.model.img_height, cfg.model.img_width, image_info(ko.frame_path(0))[:2])
        if flow_seg and ko.seg_dir is None:
            _kitti_seg_missing(f"{args.data} sequence {ko.sequence}")
        # The root's seg/ maps reach a flow_seg model (the reference drops
        # them: ROADMAP Queue 3).
        ds = SnippetDataset(
            ad, batch_size=cfg.train.batch_size, augment=augment, with_seg=flow_seg, with_gt=supervised,
        )

    logger = None
    if args.log_dir:
        from davo_tpu_torch.utils.metrics import MetricsLogger

        logger = MetricsLogger(args.log_dir)

    def log_fn(step, metrics):
        print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    stats = PrefetchStats()
    batch_iter = ds.batches(steps=cfg.train.max_steps)
    if not isinstance(ds, (SnippetDataset, MultiSourceDataset)):
        # The prepared readers yield raw batches; augment them as
        # SnippetDataset does internally.
        batch_iter = augment_batches(batch_iter, mode=augment, seed=cfg.train.seed)
    try:
        fit(
            cfg,
            device_prefetch(batch_iter, device, stats=stats),
            checkpoint_dir=args.checkpoint_dir,
            log_fn=log_fn,
            device=device,
            metrics_logger=logger,
        )
    finally:
        if logger is not None:
            logger.close()
        if hasattr(ds, "close"):
            ds.close()
    print(f"prefetch: {stats.summary()}", flush=True)
    return 0


def _serving_flags(cfg):
    """`cfg` with the fused-serving overrides validated on the card
    (BENCH_FLAGS_torch.json, written only by `utils.serving_flags.promote`
    after the serving probe's on-card equality check and frames/s win;
    gated on the serving code's fingerprint), or `cfg` as it is when no
    such file is there. The JAX package's promoted PJRT compiler options
    have no counterpart: a CUDA kernel here takes no per-computation
    compiler options."""
    from davo_tpu_torch.config import apply_overrides
    from davo_tpu_torch.utils.serving_flags import load_validated_flags

    flags = load_validated_flags()
    if not flags:
        print("infer: no validated BENCH_FLAGS for this code; serving plain config", file=sys.stderr)
        return cfg
    print(f"infer: applying BENCH_FLAGS {flags['overrides']}", file=sys.stderr)
    return apply_overrides(cfg, flags["overrides"])


def cmd_infer(args) -> int:
    import numpy as np

    from davo_tpu_torch.data.kitti import write_poses_kitti
    from davo_tpu_torch.eval.runner import (
        assemble_trajectory,
        make_pose_apply_fn,
        make_pose_apply_scan_fn,
        predict_sequence,
    )
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = _apply_sets(presets.get(args.version), args.set)
    if args.serving_flags:
        cfg = _serving_flags(cfg)
    if args.ckpt:
        model = _restore_model(cfg, args.ckpt, args.device)
        if model is None:
            return 1
    else:
        model = DavoModel(cfg.model, device=args.device)
    frames, seg, gt_poses, K = _load_sequence(
        args.data, args.seq, cfg, cfg.model.attention == "flow_seg"
    )
    # The geometric head solves with the sequence's camera (the
    # reference's `infer` drops it and cannot serve geo_hybrid).
    K = K if cfg.model.pose_head == "geo_hybrid" else None
    scan_chunks = max(1, args.scan_chunks)
    make = make_pose_apply_scan_fn if scan_chunks > 1 else make_pose_apply_fn
    rels = predict_sequence(
        make(model, K=K), frames, seg=seg, batch_size=args.batch_size, scan_chunks=scan_chunks
    )
    traj = assemble_trajectory(rels, device=args.device)
    write_poses_kitti(args.out, traj)
    if args.tum:
        from davo_tpu_torch.eval.tum import write_poses_tum

        write_poses_tum(args.tum, traj)
    if args.gt_out:
        if gt_poses is None:
            print("no GT poses available for --gt-out", file=sys.stderr)
            return 1
        write_poses_kitti(args.gt_out, np.asarray(gt_poses))
    print(f"wrote {len(traj)} poses to {args.out}")
    return 0


def cmd_depth(args) -> int:
    """Depth-map inference (reference parity: `test_kitti_depth.py`,
    SURVEY.md R3): the training forward's finest disparity as depth, one
    .npy per frame. Every frame is a target once, the next frame its
    source (the last frame's, the one before it): DispNet sees only the
    target. The reference writes frames 0..N-2 only, which its own `ba
    --depth-dir` (reading N maps) cannot take."""
    import numpy as np
    import torch

    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel
    from davo_tpu_torch.models.dispnet import disp_to_depth

    device = resolve_device(args.device)
    cfg = _apply_sets(presets.get(args.version), args.set)
    if args.ckpt:
        model = _restore_model(cfg, args.ckpt, device)
        if model is None:
            return 1
    else:
        model = DavoModel(cfg.model, device=device, seed=cfg.train.seed, dispnet=True)
    frames, _, _, K = _load_sequence(args.data, args.seq, cfg, False)
    kw = {}
    if cfg.model.pose_head == "geo_hybrid":  # the training forward runs the geometric head
        kw["K"] = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(device)
    os.makedirs(args.out, exist_ok=True)
    bs = args.batch_size
    n = len(frames)
    sources = np.concatenate([frames[1:], frames[-2:-1]])
    for start in range(0, n, bs):
        end = min(start + bs, n)
        pad = bs - (end - start)
        tgt = frames[start:end]
        src = sources[start:end]
        if pad:
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, 0)])
            src = np.concatenate([src, np.repeat(src[-1:], pad, 0)])
        with torch.inference_mode():
            out = model(torch.from_numpy(tgt).to(device), torch.from_numpy(src).to(device)[:, None],
                        train=True, **kw)
            d = disp_to_depth(out["disp"][0][..., 0]).cpu().numpy()
        for i in range(end - start):
            np.save(os.path.join(args.out, f"{start + i:06d}.npy"), d[i])
    print(f"wrote {n} depth maps to {args.out}")
    return 0


def cmd_eval(args) -> int:
    from davo_tpu_torch.data.kitti import parse_poses
    from davo_tpu_torch.eval.runner import evaluate_sequence

    with open(args.gt) as f:
        gt = parse_poses(f.read())
    with open(args.pred) as f:
        pred = parse_poses(f.read())
    n = min(len(gt), len(pred))
    report = evaluate_sequence(pred[:n], gt[:n], snippet_len=args.snippet_len)
    if args.devkit:
        from davo_tpu_torch.eval.devkit import kitti_seg_errors_cpp

        cpp = kitti_seg_errors_cpp(gt[:n], pred[:n])
        report["t_err_pct_cpp"] = cpp["t_err_pct"]
        report["r_err_deg_per_100m_cpp"] = cpp["r_err_deg_per_100m"]
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_eval_depth(args) -> int:
    """Eigen-style depth evaluation (reference parity: `eval_depth.py`,
    SURVEY.md R3/R12): per-frame median scaling, [min, max]-depth mask,
    abs_rel / sq_rel / RMSE / RMSE_log / delta accuracies. Predictions
    from --depth-dir (`depth`'s .npy files); GT from the synthetic world
    or a --gt-dir of matching .npy files."""
    import numpy as np

    from davo_tpu_torch.eval.depth_metrics import depth_errors

    files = sorted(f for f in os.listdir(args.depth_dir) if f.endswith(".npy"))
    if not files:
        print(f"no .npy depth maps in {args.depth_dir}", file=sys.stderr)
        return 1
    pred = np.stack([np.load(os.path.join(args.depth_dir, f)) for f in files])
    if args.gt_dir:
        gt = np.stack([np.load(os.path.join(args.gt_dir, f)) for f in files])
    elif args.data == "synthetic":
        from davo_tpu_torch.data.synthetic import SyntheticSequence

        s = SyntheticSequence(
            n_frames=len(files) + 1, height=pred.shape[1], width=pred.shape[2], seed=int(args.seq or 0)
        )
        gt = np.stack([s.depth(i) for i in range(len(files))])
    else:
        print("need --gt-dir for non-synthetic data", file=sys.stderr)
        return 1
    report = depth_errors(
        gt, pred, min_depth=args.min_depth, max_depth=args.max_depth,
        median_scale=not args.no_median_scale,
    )
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_ba(args) -> int:
    """Sliding-window BA refinement of a predicted trajectory (BASELINE
    config #4). Observations are flow-tracked correspondences
    (ba/tracks.py): from the checkpoint's flow net with --ckpt, else from
    the synthetic world's exact flow field; no GT pose anywhere. Depth
    from --depth-dir (`depth`'s .npy files) or the synthetic world."""
    import numpy as np

    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.ba.tracks import make_flow_fn, refine_trajectory_tracked
    from davo_tpu_torch.config import BAConfig
    from davo_tpu_torch.data.kitti import parse_poses, write_poses_kitti
    from davo_tpu_torch.data.synthetic import DYNAMIC_LABEL_START
    from davo_tpu_torch.models import presets

    device = resolve_device(args.device)
    cfg = _apply_sets(presets.get(args.version), args.set)
    model = None
    if args.ckpt:
        model = _restore_model(cfg, args.ckpt, device)
        if model is None:
            return 1
    if args.data != "synthetic" and not (args.depth_dir and model is not None):
        print("need --depth-dir and --ckpt for non-synthetic data", file=sys.stderr)
        return 1
    with open(args.pred) as f:
        pred = parse_poses(f.read())
    frames, segs, _, K = _load_sequence(args.data, args.seq, cfg, args.exclude_dynamic)
    n = len(pred)
    # The world's exact depth and flow stand in for what is not given.
    world = None if args.depth_dir and model is not None else _world(args.seq, cfg)
    if args.depth_dir:
        depths = np.stack([np.load(os.path.join(args.depth_dir, f"{i:06d}.npy")) for i in range(n)])
    else:
        depths = np.stack([world.depth(i) for i in range(n)])
    flow_fn = make_flow_fn(model, frames[:n]) if model is not None else world.gt_flow
    ba_cfg = BAConfig(
        window_size=args.window, max_iterations=args.iterations, damping=1e-3, huber_delta=3.0
    )
    refined = refine_trajectory_tracked(
        ba_cfg, pred, depths, np.asarray(K, np.float64), flow_fn,
        grid_step=args.grid_step, fb_px=args.fb_px,
        segs=segs if args.exclude_dynamic else None,
        exclude_labels=(
            tuple(range(DYNAMIC_LABEL_START, cfg.model.num_seg_classes)) if args.exclude_dynamic else ()
        ),
        device=device,
    )
    write_poses_kitti(args.out, refined)
    print(f"refined {n} poses -> {args.out}")
    return 0


def cmd_bench(args) -> int:
    """bench.py's JSON line (`python -m davo_tpu_torch.bench`); --version
    is accepted and ignored, as the reference's `cli bench` does."""
    from davo_tpu_torch.bench.__main__ import main as bench_main

    bench_main(args.device)
    return 0


PLATFORMS_REASON = (
    "--platforms (a torch.export program is not lowered per platform: it "
    "runs wherever torch runs, and dispatches the cost-volume op by the "
    "device of its inputs)"
)


def cmd_export(args) -> int:
    """Save the pose-inference forward as a `torch.export` program (.pt2):
    (target, source, seg) -> (B, 6) poses, parameters baked in, batch and
    resolution fixed (the reference's StableHLO export). The cost volume
    is the registered op `davo::cost_volume` (and the fused chains under
    the serving flags `davo::conv_chain_strided`, `conv_chain_nhwc`,
    `flow_level_fused`), one node per call, so the reloaded program
    launches the kernels on the card and runs the plain versions on the
    CPU; load it with `davo_tpu_torch.kernels.rowconv` imported, which
    registers all four (`torch.export.load(path).module()(target, source,
    seg)`)."""
    if args.platforms:
        return _refuse("export", PLATFORMS_REASON)
    import time

    import numpy as np
    import torch

    from davo_tpu_torch import resolve_device
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    class PoseForward(torch.nn.Module):
        """The reference's exported function: seg reaches the model only
        under attention="flow_seg"."""

        def __init__(self, model):
            super().__init__()
            self.model = model
            self.with_seg = model.cfg.attention == "flow_seg"

        def forward(self, target, source, seg):
            out = self.model(target, source[:, None], seg=seg if self.with_seg else None)
            return out["poses"][:, 0]

    device = resolve_device(args.device)
    cfg = _apply_sets(presets.get(args.version), args.set)
    H, W = cfg.model.img_height, cfg.model.img_width
    B = args.batch_size
    if args.ckpt:
        model = _restore_model(cfg, args.ckpt, device)
        if model is None:
            return 1
    else:
        model = DavoModel(cfg.model, device=device, seed=cfg.train.seed).eval()
        print("warning: exporting UNTRAINED params (no --ckpt)", file=sys.stderr)
    rng = np.random.default_rng(0)
    example = (
        torch.from_numpy(rng.uniform(size=(B, H, W, 3)).astype(np.float32)).to(device),
        torch.from_numpy(rng.uniform(size=(B, H, W, 3)).astype(np.float32)).to(device),
        torch.from_numpy(rng.integers(0, cfg.model.num_seg_classes, (B, H, W)).astype(np.int32)).to(device),
    )
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(PoseForward(model), example)
    torch.export.save(program, args.out)
    print(
        f"exported {args.version} pose forward (B={B}, {H}x{W}, {device.type}) -> {args.out} "
        f"({os.path.getsize(args.out)} bytes, {time.perf_counter() - t0:.1f} s)"
    )
    return 0


def cmd_train_seg(args) -> int:
    """Train the in-repo segmentation source on synthetic labels and save
    a checkpoint that `prep --write-seg` (of either package) reads."""
    from davo_tpu_torch.models.segnet import save_segnet
    from davo_tpu_torch.train.seg import train_segnet

    model, metrics = train_segnet(
        steps=args.steps, batch_size=args.batch_size, height=args.height, width=args.width,
        seed=args.seed, channels=tuple(int(c) for c in args.channels.split(",")),
        device=args.device,
    )
    save_segnet(args.checkpoint_dir, model)
    print(json.dumps(metrics))
    return 0


def cmd_prep(args) -> int:
    """Offline dataset preparation (reference parity: SURVEY.md R11
    `<ref>/data/prepare_train_data.py`), plus `--write-seg`: stamp
    SegNetLite's `*_seg.png` labels onto the prepared tree so flow_seg
    trains without external segmentation."""
    from davo_tpu_torch.data import prep as dprep

    if args.dataset is not None:
        if not args.root:
            print("--dataset needs --root <raw dataset dir>", file=sys.stderr)
            return 2
        fn = {
            "kitti_odom": dprep.prepare_kitti_odometry,
            "kitti_raw": dprep.prepare_kitti_raw,
            "cityscapes": dprep.prepare_cityscapes,
        }[args.dataset]
        kwargs = dict(root=args.root, out_dir=args.out, height=args.height, width=args.width,
                      num_workers=args.num_workers)
        if args.dataset == "kitti_odom" and args.seqs:
            kwargs["seqs"] = tuple(args.seqs.split(","))
        print(f"prepared {fn(**kwargs)}")
    if args.write_seg:
        if not args.seg_ckpt:
            print("--write-seg needs --seg-ckpt (see `train-seg`)", file=sys.stderr)
            return 2
        from davo_tpu_torch.models.segnet import make_seg_infer

        n = dprep.annotate_prepared_seg(
            args.out, make_seg_infer(args.seg_ckpt, args.device),
            batch_size=args.batch_size, overwrite=args.overwrite_seg,
        )
        print(f"wrote {n} seg maps into {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="davo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: the GPU; 'cpu' to run on the CPU)"

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--version", default="davo")
    t.add_argument("--data", default="synthetic", help="'synthetic', a prepared tree or a KITTI root")
    t.add_argument("--seq", default=None, help="KITTI root only: the sequence (default 00)")
    t.add_argument("--world-class", default="loop", choices=("loop", "wander", "drive"))
    t.add_argument("--worlds", type=int, default=16, help="number of synthetic train worlds")
    t.add_argument("--world-frames", type=int, default=24, help="frames per train world")
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--log-dir", default=None, help="metrics.jsonl, images/ and TensorBoard events")
    t.add_argument("--set", action="append", help="dotted override k=v")
    t.add_argument(
        "--loader", default="auto", choices=("auto", "native", "python"),
        help="prepared-layout reader: C++ decode pool or python",
    )
    t.add_argument("--device", default=None, help=device_help)
    t.set_defaults(fn=cmd_train)
    i = sub.add_parser("infer", help="predict a trajectory")
    i.add_argument("--version", default="davo")
    i.add_argument("--data", default="synthetic", help="'synthetic' or a KITTI root")
    i.add_argument("--seq", default="09")
    i.add_argument("--ckpt", default=None, help="serve the newest checkpoint in this directory")
    i.add_argument("--out", required=True)
    i.add_argument("--tum", default=None, help="also write TUM-format file")
    i.add_argument(
        "--gt-out", default=None,
        help="also write the sequence's GT trajectory (KITTI format)",
    )
    i.add_argument("--batch-size", type=int, default=32)
    i.add_argument(
        "--scan-chunks", type=int, default=1,
        help="pair batches per call (N > 1: one copy to the device per N batches)",
    )
    i.add_argument(
        "--serving-flags", action="store_true",
        help="apply the fused-serving flags validated on the card for this code "
        "(BENCH_FLAGS_torch.json at the repo root; none: the plain config)",
    )
    i.add_argument("--set", action="append", help="dotted override k=v")
    i.add_argument("--device", default=None, help=device_help)
    i.set_defaults(fn=cmd_infer)
    d = sub.add_parser("depth", help="depth-map inference")
    d.add_argument("--version", default="davo")
    d.add_argument("--data", default="synthetic", help="'synthetic' or a KITTI root")
    d.add_argument("--seq", default="09")
    d.add_argument("--ckpt", default=None)
    d.add_argument("--out", required=True)
    d.add_argument("--batch-size", type=int, default=32)
    d.add_argument("--set", action="append", help="dotted override k=v")
    d.add_argument("--device", default=None, help=device_help)
    d.set_defaults(fn=cmd_depth)
    e = sub.add_parser("eval", help="evaluate a trajectory vs GT")
    e.add_argument("--gt", required=True)
    e.add_argument("--pred", required=True)
    e.add_argument("--snippet-len", type=int, default=5)
    e.add_argument("--devkit", action="store_true", help="also run C++ devkit")
    e.set_defaults(fn=cmd_eval)
    ed = sub.add_parser("eval-depth", help="evaluate depth maps vs GT")
    ed.add_argument("--depth-dir", required=True)
    ed.add_argument("--gt-dir", default=None)
    ed.add_argument("--data", default="synthetic")
    ed.add_argument("--seq", default="0")
    ed.add_argument("--min-depth", type=float, default=1e-3)
    ed.add_argument("--max-depth", type=float, default=80.0)
    ed.add_argument("--no-median-scale", action="store_true")
    ed.set_defaults(fn=cmd_eval_depth)
    a = sub.add_parser("ba", help="sliding-window BA refinement")
    a.add_argument("--version", default="davo")
    a.add_argument("--data", default="synthetic", help="'synthetic' or a KITTI root")
    a.add_argument("--seq", default="09")
    a.add_argument("--pred", required=True, help="predicted trajectory (KITTI fmt)")
    a.add_argument("--depth-dir", default=None)
    a.add_argument("--ckpt", default=None, help="model ckpt for flow tracks")
    a.add_argument("--out", required=True)
    a.add_argument("--window", type=int, default=8)
    a.add_argument("--iterations", type=int, default=8)
    a.add_argument("--grid-step", type=int, default=8)
    a.add_argument("--fb-px", type=float, default=1.0, help="forward-backward track gate (pixels)")
    a.add_argument("--exclude-dynamic", action="store_true", help="drop anchors on dynamic seg classes (11-18)")
    a.add_argument("--set", action="append", help="dotted override k=v")
    a.add_argument("--device", default=None, help=device_help)
    a.set_defaults(fn=cmd_ba)
    x = sub.add_parser("export", help="save the pose forward as a torch.export program (.pt2)")
    x.add_argument("--version", default="davo-fast")
    x.add_argument("--ckpt", default=None)
    x.add_argument("--out", required=True)
    x.add_argument("--batch-size", type=int, default=128)
    x.add_argument("--platforms", default=None, help="refused: a torch.export program is not lowered per platform")
    x.add_argument("--set", action="append", help="dotted override k=v")
    x.add_argument("--device", default=None, help=device_help)
    x.set_defaults(fn=cmd_export)
    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("--version", default="davo", help="ignored, as in the reference")
    b.add_argument("--device", default=None, help=device_help)
    b.set_defaults(fn=cmd_bench)
    ts = sub.add_parser("train-seg", help="train the in-repo segmentation source")
    ts.add_argument("--checkpoint-dir", required=True)
    ts.add_argument("--steps", type=int, default=600)
    ts.add_argument("--batch-size", type=int, default=8)
    ts.add_argument("--height", type=int, default=128)
    ts.add_argument("--width", type=int, default=416)
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--channels", default="16,32,64,128")
    ts.add_argument("--device", default=None, help=device_help)
    ts.set_defaults(fn=cmd_train_seg)
    pp = sub.add_parser("prep", help="offline dataset preparation (+ seg annotation)")
    pp.add_argument(
        "--dataset", default=None, choices=("kitti_odom", "kitti_raw", "cityscapes"),
        help="omit to only annotate an existing prepared tree",
    )
    pp.add_argument("--root", default=None, help="raw dataset root")
    pp.add_argument("--out", required=True, help="prepared tree dir")
    pp.add_argument("--height", type=int, default=128)
    pp.add_argument("--width", type=int, default=416)
    pp.add_argument("--seqs", default=None, help="kitti_odom seq list, comma")
    pp.add_argument("--num-workers", type=int, default=4)
    pp.add_argument("--write-seg", action="store_true")
    pp.add_argument("--seg-ckpt", default=None)
    pp.add_argument("--overwrite-seg", action="store_true")
    pp.add_argument("--batch-size", type=int, default=16)
    pp.add_argument("--device", default=None, help=device_help + "; labels with --write-seg")
    pp.set_defaults(fn=cmd_prep)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
