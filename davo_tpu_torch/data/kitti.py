"""KITTI odometry dataset IO.

Host-side readers for the KITTI odometry benchmark layout (images
through the port's codec, `data/imageio.py`):

    root/
      sequences/NN/image_2/*.png    (left color camera)
      sequences/NN/calib.txt        (P0..P3 3x4 projections)
      sequences/NN/times.txt
      poses/NN.txt                  (GT: 12 floats/row = 3x4 [R|t], cam0)

Reference parity: `<ref>/data/kitti_odom_loader.py` + the pose-file IO
in `<ref>/kitti_eval/pose_evaluation_utils.py` (SURVEY.md R11/R12/R14).
Train split seqs 00-08, eval 09-10 (reference convention).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from davo_tpu_torch.data import imageio

TRAIN_SEQS = tuple(f"{i:02d}" for i in range(9))
EVAL_SEQS = ("09", "10")


def parse_calib(text: str) -> dict[str, np.ndarray]:
    """Parse a KITTI calib.txt: lines 'Pi: v0 v1 ... v11' -> (3, 4)."""
    out: dict[str, np.ndarray] = {}
    for line in text.strip().splitlines():
        if ":" not in line:
            continue
        key, vals = line.split(":", 1)
        # Tolerate non-numeric lines (e.g. kitti-raw calib_cam_to_cam's
        # 'calib_time: 09-Jan-2012 13:57:47'), like np.fromstring did.
        try:
            arr = np.array(vals.split(), dtype=np.float64)
        except ValueError:
            continue
        if arr.size == 12:
            out[key.strip()] = arr.reshape(3, 4)
        elif arr.size:
            out[key.strip()] = arr
    return out


def intrinsics_from_projection(P: np.ndarray) -> np.ndarray:
    """3x4 projection -> 3x3 K (KITTI rectified: K = P[:, :3])."""
    return P[:3, :3].copy()


def parse_poses(text: str) -> np.ndarray:
    """KITTI GT pose file -> (N, 4, 4). Each row: 12 floats of [R|t]."""
    rows = np.loadtxt(text.strip().splitlines() if "\n" in text else [text])
    rows = np.atleast_2d(rows)
    n = rows.shape[0]
    mats = np.tile(np.eye(4), (n, 1, 1))
    mats[:, :3, :4] = rows.reshape(n, 3, 4)
    return mats


def format_poses_kitti(poses: np.ndarray) -> str:
    """(N, 4, 4) -> KITTI 12-value row text (inverse of `parse_poses`)."""
    rows = poses[:, :3, :4].reshape(len(poses), 12)
    return "\n".join(" ".join(f"{v:.9e}" for v in row) for row in rows) + "\n"


def write_poses_kitti(path: str, poses: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(format_poses_kitti(poses))


def _load_frame(path: str, height: int | None, width: int | None) -> np.ndarray:
    """A frame as float32 HWC RGB in [0, 1], INTER_AREA-resized to
    (height, width) when both are given (the reference's cv2 calls)."""
    img = imageio.imread_rgb(path)
    if height is not None and width is not None:
        img = imageio.resize_area(img, height, width)
    return img.astype(np.float32) / 255.0


@dataclass
class KittiOdometry:
    """One KITTI odometry sequence on disk (host-side, lazy frame IO)."""

    root: str
    sequence: str
    image_dir: str = field(init=False)
    frames: list[str] = field(init=False)
    K: np.ndarray = field(init=False)
    times: np.ndarray | None = field(init=False, default=None)
    gt_poses: np.ndarray | None = field(init=False, default=None)

    def __post_init__(self):
        seq_dir = os.path.join(self.root, "sequences", self.sequence)
        self.image_dir = os.path.join(seq_dir, "image_2")
        self.frames = sorted(
            f
            for f in os.listdir(self.image_dir)
            if f.endswith((".png", ".jpg"))
        )
        with open(os.path.join(seq_dir, "calib.txt")) as f:
            calib = parse_calib(f.read())
        self.K = intrinsics_from_projection(calib["P2"])
        times_path = os.path.join(seq_dir, "times.txt")
        if os.path.exists(times_path):
            self.times = np.loadtxt(times_path)
        gt_path = os.path.join(self.root, "poses", self.sequence + ".txt")
        if os.path.exists(gt_path):
            with open(gt_path) as f:
                self.gt_poses = parse_poses(f.read())

    def __len__(self) -> int:
        return len(self.frames)

    def frame_path(self, i: int) -> str:
        return os.path.join(self.image_dir, self.frames[i])

    def load_frame(self, i: int, height: int | None = None, width: int | None = None) -> np.ndarray:
        """Load frame i as float32 HWC in [0, 1], optionally resized."""
        return _load_frame(self.frame_path(i), height, width)

    @property
    def seg_dir(self) -> str | None:
        """Directory of precomputed per-frame segmentation label maps
        (reference parity: DAVO loads offline DeepLab Cityscapes-19
        labels, `<ref>/data_loader.py`, SURVEY.md R8). Layout:
        sequences/NN/seg/<frame>.png, uint8 label ids."""
        d = os.path.join(
            self.root, "sequences", self.sequence, "seg"
        )
        return d if os.path.isdir(d) else None

    def load_seg(
        self, i: int, height: int | None = None, width: int | None = None
    ) -> np.ndarray:
        """Load the frame-i label map as int32 (H, W), nearest-resized."""
        stem = os.path.splitext(self.frames[i])[0]
        path = os.path.join(self.seg_dir, stem + ".png")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        seg = imageio.imread_gray(path)
        if height is not None and width is not None:
            seg = imageio.resize_nearest(seg, height, width)
        return seg.astype(np.int32)

    def scaled_intrinsics(self, height: int, width: int, native_hw: tuple[int, int]) -> np.ndarray:
        """K rescaled from native (H, W) to a target resolution."""
        nh, nw = native_hw
        K = self.K.copy()
        K[0] *= width / nw
        K[1] *= height / nh
        return K


@dataclass
class KittiRaw:
    """One KITTI *raw* drive (reference parity:
    `<ref>/data/kitti_raw_loader.py`, SURVEY.md R11). Layout:

        root/<date>/calib_cam_to_cam.txt     (P_rect_02 etc.)
        root/<date>/<date>_drive_NNNN_sync/image_02/data/*.png
        root/<date>/<date>_drive_NNNN_sync/oxts/data/*.txt (optional)

    oxts rows are the KITTI GPS/IMU format (lat lon alt roll pitch yaw
    vn ve vf ...); the reference drops near-static frames by GPS
    speed, mirrored here via `speeds()` + `min_speed` in
    `prepare_kitti_raw`.
    """

    root: str
    date: str
    drive: str  # 4-digit id, e.g. "0001"
    image_dir: str = field(init=False)
    frames: list[str] = field(init=False)
    K: np.ndarray = field(init=False)

    def __post_init__(self):
        self.drive_dir = os.path.join(
            self.root, self.date, f"{self.date}_drive_{self.drive}_sync"
        )
        self.image_dir = os.path.join(self.drive_dir, "image_02", "data")
        self.frames = sorted(
            f
            for f in os.listdir(self.image_dir)
            if f.endswith((".png", ".jpg"))
        )
        with open(
            os.path.join(self.root, self.date, "calib_cam_to_cam.txt")
        ) as f:
            calib = parse_calib(f.read())
        self.K = intrinsics_from_projection(calib["P_rect_02"])

    @staticmethod
    def list_drives(root: str) -> list[tuple[str, str]]:
        """All (date, drive) pairs under `root`."""
        out = []
        for date in sorted(os.listdir(root)):
            ddir = os.path.join(root, date)
            if not os.path.isdir(ddir):
                continue
            for name in sorted(os.listdir(ddir)):
                if name.startswith(date + "_drive_") and name.endswith(
                    "_sync"
                ):
                    out.append((date, name[len(date) + 7 : -5]))
        return out

    def __len__(self) -> int:
        return len(self.frames)

    def frame_path(self, i: int) -> str:
        return os.path.join(self.image_dir, self.frames[i])

    def load_frame(
        self, i: int, height: int | None = None, width: int | None = None
    ) -> np.ndarray:
        return _load_frame(self.frame_path(i), height, width)

    def speeds(self) -> np.ndarray | None:
        """Per-frame ground speed |(vn, ve)| m/s from oxts, or None."""
        oxts = os.path.join(self.drive_dir, "oxts", "data")
        if not os.path.isdir(oxts):
            return None
        rows = []
        for f in sorted(os.listdir(oxts)):
            if not f.endswith(".txt"):
                continue
            vals = np.fromstring(
                open(os.path.join(oxts, f)).read(), sep=" "
            )
            rows.append(np.hypot(vals[6], vals[7]) if len(vals) > 7 else 0.0)
        return np.asarray(rows, np.float64) if rows else None

    def scaled_intrinsics(
        self, height: int, width: int, native_hw: tuple[int, int]
    ) -> np.ndarray:
        nh, nw = native_hw
        K = self.K.copy()
        K[0] *= width / nw
        K[1] *= height / nh
        return K


@dataclass
class CityscapesSeq:
    """One Cityscapes leftImg8bit_sequence group (reference parity:
    `<ref>/data/cityscapes_loader.py`, SURVEY.md R11 optional source).
    Layout:

        root/leftImg8bit_sequence/<split>/<city>/
            <city>_<seq>_<frame>_leftImg8bit.png
        root/camera/<split>/<city>/<city>_<seq>_<frame>_camera.json
            {"intrinsic": {"fx", "fy", "u0", "v0"}}

    A "sequence" here is one (city, seq-id) 30-frame snippet group.
    """

    root: str
    split: str
    city: str
    seq: str  # 6-digit id
    frames: list[str] = field(init=False)
    K: np.ndarray = field(init=False)

    def __post_init__(self):
        self.image_dir = os.path.join(
            self.root, "leftImg8bit_sequence", self.split, self.city
        )
        prefix = f"{self.city}_{self.seq}_"
        self.frames = sorted(
            f
            for f in os.listdir(self.image_dir)
            if f.startswith(prefix) and f.endswith("_leftImg8bit.png")
        )
        self.K = self._load_K()

    def _load_K(self) -> np.ndarray:
        import json as _json

        import glob as _glob

        cam_dir = os.path.join(self.root, "camera", self.split, self.city)
        # Any frame's camera json works (fixed rig per sequence) — but
        # the real Cityscapes camera package ships a json only for the
        # ANNOTATED frame of each 30-frame group (e.g. *_000019_*),
        # not frame 0, so search the group's jsons rather than
        # assuming frames[0] has one.
        stem = self.frames[0][: -len("_leftImg8bit.png")]
        path = os.path.join(cam_dir, stem + "_camera.json")
        if not os.path.exists(path):
            matches = sorted(
                _glob.glob(
                    os.path.join(
                        cam_dir, f"{self.city}_{self.seq}_*_camera.json"
                    )
                )
            ) or sorted(_glob.glob(os.path.join(cam_dir, "*_camera.json")))
            if not matches:
                raise FileNotFoundError(
                    f"no camera json for {self.city}_{self.seq} in {cam_dir}"
                )
            path = matches[0]
        with open(path) as f:
            intr = _json.load(f)["intrinsic"]
        return np.array(
            [
                [intr["fx"], 0.0, intr["u0"]],
                [0.0, intr["fy"], intr["v0"]],
                [0.0, 0.0, 1.0],
            ],
            np.float64,
        )

    @staticmethod
    def list_sequences(root: str, split: str = "train") -> list[tuple[str, str]]:
        """All (city, seq) groups under leftImg8bit_sequence/<split>."""
        base = os.path.join(root, "leftImg8bit_sequence", split)
        out = set()
        for city in sorted(os.listdir(base)):
            cdir = os.path.join(base, city)
            if not os.path.isdir(cdir):
                continue
            for f in os.listdir(cdir):
                if f.endswith("_leftImg8bit.png"):
                    out.add((city, f.split("_")[1]))
        return sorted(out)

    def __len__(self) -> int:
        return len(self.frames)

    def frame_path(self, i: int) -> str:
        return os.path.join(self.image_dir, self.frames[i])

    def load_frame(
        self, i: int, height: int | None = None, width: int | None = None
    ) -> np.ndarray:
        return _load_frame(self.frame_path(i), height, width)

    def scaled_intrinsics(
        self, height: int, width: int, native_hw: tuple[int, int]
    ) -> np.ndarray:
        nh, nw = native_hw
        K = self.K.copy()
        K[0] *= width / nw
        K[1] *= height / nh
        return K
