"""Offline dataset preparation: raw KITTI -> training snippet dirs (port
of davo_tpu.data.prep).

Reference parity: `<ref>/data/prepare_train_data.py` +
`kitti_odom_loader.py` / `kitti_raw_loader.py` (SURVEY.md R11 [H]):
resize frames, write `[I_{t-1} I_t I_{t+1}]` horizontally-concatenated
snippet images plus per-snippet `*_cam.txt` intrinsics and train/val
split lists, with a process pool over frames; raw drives drop
near-static frames by GPS speed.

The layout is the reference's, byte for byte where it is text (`str` of
each float joined by commas; split lists from `default_rng(seed)`), and
the images are what the reference's OpenCV calls write (the codec of
`data/imageio.py` writes the same JPEG bytes and PNG pixels), so each
package reads the other's tree. The workers are host-only processes
(spawned, never forked from a process that may hold a CUDA context).
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from davo_tpu_torch.data import imageio
from davo_tpu_torch.data.kitti import TRAIN_SEQS, CityscapesSeq, KittiOdometry, KittiRaw


def _floats_text(values: np.ndarray) -> str:
    return ",".join(str(v) for v in np.asarray(values).ravel())


def _read_floats(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([float(v) for v in f.read().strip().split(",")], np.float64)


def _write_triplet(src, t: int, name: str, out_dir: str, height: int, width: int, native_hw) -> None:
    """`<name>.jpg` (frames t-1, t, t+1 side by side) and `<name>_cam.txt`."""
    frames = [(src.load_frame(i, height, width) * 255).astype(np.uint8) for i in (t - 1, t, t + 1)]
    imageio.imwrite_jpg(os.path.join(out_dir, name + ".jpg"), np.concatenate(frames, axis=1))
    K = src.scaled_intrinsics(height, width, native_hw)
    with open(os.path.join(out_dir, name + "_cam.txt"), "w") as f:
        f.write(_floats_text(K))


def _write_snippet(args) -> str:
    root, seq, t, out_dir, height, width, native_hw = args
    ko = KittiOdometry(root, seq)
    name = f"{seq}_{t:06d}"
    _write_triplet(ko, t, name, out_dir, height, width, native_hw)
    if ko.seg_dir is not None:
        # Target frame's labels only (the model consumes target seg); PNG,
        # so labels survive losslessly.
        imageio.imwrite_png(
            os.path.join(out_dir, name + "_seg.png"),
            ko.load_seg(t, height, width).astype(np.uint8),
        )
    if ko.gt_poses is not None:
        # One 4x4 per source, mapping TARGET-cam points to SOURCE-cam
        # points (model convention; see snippets.KittiAdapter.gt_rel).
        P = ko.gt_poses
        past = np.linalg.inv(P[t - 1]) @ P[t]
        futr = np.linalg.inv(P[t + 1]) @ P[t]
        with open(os.path.join(out_dir, name + "_pose.txt"), "w") as f:
            f.write(_floats_text(np.stack([past, futr])))
    return name


def _write_raw_snippet(args) -> str:
    root, date, drive, t, out_dir, height, width, native_hw = args
    name = f"{date}_{drive}_{t:06d}"
    _write_triplet(KittiRaw(root, date, drive), t, name, out_dir, height, width, native_hw)
    return name


def _write_cityscapes_snippet(args) -> str:
    root, split, city, seq, t, out_dir, height, width, native_hw = args
    name = f"{city}_{seq}_{t:06d}"
    _write_triplet(CityscapesSeq(root, split, city, seq), t, name, out_dir, height, width, native_hw)
    return name


def _run(fn, jobs: list, num_workers: int) -> list[str]:
    imageio.load_library()  # build once, before the workers load it
    if num_workers > 1 and len(jobs) > 1:
        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            return pool.map(fn, jobs)
    return [fn(j) for j in jobs]


def _write_splits(out_dir: str, names: list[str], val_fraction: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(names))
    n_val = int(len(names) * val_fraction)
    val = sorted(names[i] for i in order[:n_val])
    train = sorted(names[i] for i in order[n_val:])
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(out_dir, "val.txt"), "w") as f:
        f.write("\n".join(val) + "\n")
    return {"train": len(train), "val": len(val)}


def prepare_kitti_odometry(
    root: str,
    out_dir: str,
    height: int = 128,
    width: int = 416,
    seqs: tuple = TRAIN_SEQS,
    num_workers: int = 4,
    val_fraction: float = 0.1,
    seed: int = 0,
) -> dict:
    """Build the reference-layout training set. Returns counts."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for seq in seqs:
        ko = KittiOdometry(root, seq)
        native_hw = imageio.image_info(ko.frame_path(0))[:2]
        for t in range(1, len(ko) - 1):
            jobs.append((root, seq, t, out_dir, height, width, native_hw))
    names = _run(_write_snippet, jobs, num_workers)
    return _write_splits(out_dir, names, val_fraction, seed)


def prepare_kitti_raw(
    root: str,
    out_dir: str,
    height: int = 128,
    width: int = 416,
    drives: list[tuple[str, str]] | None = None,
    num_workers: int = 4,
    val_fraction: float = 0.1,
    min_speed: float = 1.0,
    seed: int = 0,
) -> dict:
    """Build the reference-layout training set from raw drives.

    A triplet is kept only if all three frames move faster than
    `min_speed` m/s (oxts GPS; drives without oxts keep everything) —
    the reference's static-scene exclusion. Returns counts."""
    os.makedirs(out_dir, exist_ok=True)
    if drives is None:
        drives = KittiRaw.list_drives(root)
    jobs = []
    n_static = 0
    for date, drive in drives:
        kr = KittiRaw(root, date, drive)
        native_hw = imageio.image_info(kr.frame_path(0))[:2]
        speeds = kr.speeds()
        for t in range(1, len(kr) - 1):
            if speeds is not None and float(speeds[t - 1 : t + 2].min()) < min_speed:
                n_static += 1
                continue
            jobs.append((root, date, drive, t, out_dir, height, width, native_hw))
    names = _run(_write_raw_snippet, jobs, num_workers)
    return {**_write_splits(out_dir, names, val_fraction, seed), "static_dropped": n_static}


def prepare_cityscapes(
    root: str,
    out_dir: str,
    height: int = 128,
    width: int = 416,
    split: str = "train",
    num_workers: int = 4,
    val_fraction: float = 0.1,
    seed: int = 0,
) -> dict:
    """Build the reference-layout set from leftImg8bit_sequence groups
    (`<ref>/data/cityscapes_loader.py` analog). Returns counts."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for city, seq in CityscapesSeq.list_sequences(root, split):
        cs = CityscapesSeq(root, split, city, seq)
        native_hw = imageio.image_info(cs.frame_path(0))[:2]
        for t in range(1, len(cs) - 1):
            jobs.append((root, split, city, seq, t, out_dir, height, width, native_hw))
    names = _run(_write_cityscapes_snippet, jobs, num_workers)
    return _write_splits(out_dir, names, val_fraction, seed)


class PreparedSnippets:
    """Reader for the offline layout: dict batches shaped like
    `SnippetDataset`'s from the concatenated-triplet files."""

    def __init__(self, data_dir: str, split: str = "train", seed: int = 0):
        self.dir = data_dir
        with open(os.path.join(data_dir, f"{split}.txt")) as f:
            self.names = [line.strip() for line in f if line.strip()]
        self.rng = np.random.default_rng(seed)
        # Prepared sets are uniform: presence checked on one item.
        self.has_seg = bool(self.names) and os.path.exists(
            os.path.join(data_dir, self.names[0] + "_seg.png")
        )
        self.has_gt = bool(self.names) and os.path.exists(
            os.path.join(data_dir, self.names[0] + "_pose.txt")
        )

    def __len__(self) -> int:
        return len(self.names)

    def load(self, name: str) -> dict:
        img = imageio.imread_rgb(os.path.join(self.dir, name + ".jpg")).astype(np.float32) / 255.0
        w = img.shape[1] // 3
        prev_f, tgt, nxt = img[:, :w], img[:, w : 2 * w], img[:, 2 * w :]
        K = _read_floats(os.path.join(self.dir, name + "_cam.txt")).reshape(3, 3)
        out = {"target": tgt, "sources": np.stack([prev_f, nxt]), "K": K.astype(np.float32)}
        if self.has_seg:
            seg_path = os.path.join(self.dir, name + "_seg.png")
            if not os.path.exists(seg_path):  # partially-populated dir: name the file
                raise FileNotFoundError(seg_path)
            out["seg"] = imageio.imread_gray(seg_path).astype(np.int32)
        if self.has_gt:
            gt = _read_floats(os.path.join(self.dir, name + "_pose.txt"))
            out["gt_pose"] = gt.reshape(2, 4, 4).astype(np.float32)
        return out

    def batches(self, batch_size: int, steps: int | None = None):
        produced = 0
        while steps is None or produced < steps:
            order = self.rng.permutation(self.names)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                items = [self.load(n) for n in order[start : start + batch_size]]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
                produced += 1
                if steps is not None and produced >= steps:
                    return
            if len(self.names) < batch_size:
                return


def annotate_prepared_seg(data_dir: str, infer_fn, batch_size: int = 16, overwrite: bool = False) -> int:
    """Stamp `*_seg.png` onto an existing prepared tree.

    `infer_fn`: batched labeler (B, H, W, 3) float [0,1] -> (B, H, W)
    uint8 (see `models.segnet.make_seg_infer`). Labels the TARGET
    (middle) frame of every snippet, the only one the model consumes.
    Returns the number of files written."""
    names = []
    for split in ("train", "val"):
        path = os.path.join(data_dir, f"{split}.txt")
        if os.path.exists(path):
            with open(path) as f:
                names += [line.strip() for line in f if line.strip()]
    todo = [
        n for n in names if overwrite or not os.path.exists(os.path.join(data_dir, n + "_seg.png"))
    ]
    written = 0
    for start in range(0, len(todo), batch_size):
        chunk = todo[start : start + batch_size]
        imgs = []
        for n in chunk:
            path = os.path.join(data_dir, n + ".jpg")
            try:
                img = imageio.imread_rgb(path)
            except OSError as e:  # missing/corrupt snippet jpg
                raise FileNotFoundError(f"annotate_prepared_seg: unreadable snippet {path}") from e
            w = img.shape[1] // 3
            imgs.append(img[:, w : 2 * w].astype(np.float32) / 255.0)
        labels = np.asarray(infer_fn(np.stack(imgs)))
        for n, lab in zip(chunk, labels):
            imageio.imwrite_png(os.path.join(data_dir, n + "_seg.png"), lab.astype(np.uint8))
            written += 1
    return written
