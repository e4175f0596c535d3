"""TUM trajectory format IO: `timestamp tx ty tz qx qy qz qw` (port of
davo_tpu.eval.tum).

Reference parity: `dump_pose_seq_TUM` in the reference's
`kitti_eval/pose_evaluation_utils.py` (SURVEY.md R12); tools of that
ecosystem (evo, the TUM scripts) read this layout. Host-side text IO on
the CPU, in float64 so that the text holds its 9 decimals; the
quaternions by the port's `mat_to_quat` (Shepperd's method), which
round-trips a near-identity rotation where the reference's form loses
~1e-4 of it.
"""

from __future__ import annotations

import numpy as np
import torch

from davo_tpu_torch.core import geometry as geo


def format_poses_tum(poses: np.ndarray, times: np.ndarray | None = None) -> str:
    """(N, 4, 4) absolute poses (+ optional timestamps) -> TUM text."""
    n = len(poses)
    if times is None:
        times = np.arange(n, dtype=np.float64)
    rot = torch.as_tensor(np.asarray(poses)[:, :3, :3], dtype=torch.float64)
    quats = geo.mat_to_quat(rot).numpy()
    lines = []
    for i in range(n):
        t = poses[i, :3, 3]
        q = quats[i]
        lines.append(
            f"{times[i]:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
        )
    return "\n".join(lines) + "\n"


def parse_poses_tum(text: str) -> tuple[np.ndarray, np.ndarray]:
    """TUM text -> (times (N,), poses (N, 4, 4))."""
    rows = np.atleast_2d(np.loadtxt(text.strip().splitlines()))
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, 3] = rows[:, 1:4]
    poses[:, :3, :3] = geo.quat_to_mat(torch.as_tensor(rows[:, 4:8], dtype=torch.float64)).numpy()
    return rows[:, 0], poses


def write_poses_tum(path: str, poses: np.ndarray, times: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        f.write(format_poses_tum(poses, times))
