"""Sliding-window BA orchestration over a VO trajectory (port of
davo_tpu.ba.window).

Builds fixed-shape `BAProblem`s from the VO front end's outputs (poses +
depth maps; correspondences from projected grid landmarks), refines each
window with `ba_refine` on the device, and stitches the refined poses
back into the global trajectory (BASELINE config #4, single host).
Problem assembly is host numpy, as in the reference.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from davo_tpu_torch import exact_f32, resolve_device
from davo_tpu_torch.ba.gn import BAProblem, ba_refine
from davo_tpu_torch.config import BAConfig


def window_starts(n_frames: int, window_size: int, stride: int) -> list[int]:
    """Start indices covering [0, n_frames) with sliding windows.

    The stride loop alone can stop short of the tail (len=10, M=5,
    stride=2 -> last start 4, frame 9 never refined); a final window
    clamped to end at n_frames guarantees full coverage.
    """
    starts = list(range(0, max(n_frames - window_size + 1, 1), stride))
    last = max(n_frames - window_size, 0)
    if starts[-1] != last:
        starts.append(last)
    return starts


def sample_grid_landmarks(
    depth: np.ndarray, K: np.ndarray, pose_wc: np.ndarray, step: int = 8
) -> np.ndarray:
    """Backproject a sparse pixel grid of a keyframe to world points.

    depth: (H, W); pose_wc: (4, 4) cam-to-world. Returns (N, 3).
    """
    H, W = depth.shape
    vs, us = np.mgrid[step // 2 : H : step, step // 2 : W : step]
    us, vs = us.ravel(), vs.ravel()
    z = depth[vs, us]
    x = (us - K[0, 2]) / K[0, 0] * z
    y = (vs - K[1, 2]) / K[1, 1] * z
    p_c = np.stack([x, y, z], -1)
    return (pose_wc[:3, :3] @ p_c.T).T + pose_wc[:3, 3]


def f32_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` cast to float32 on the host, then moved to `device`, as the
    reference's `jnp.asarray(a, jnp.float32)`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def problem_from_numpy(poses_cw, points_w, K, observations, mask, device=None) -> BAProblem:
    """A BAProblem of float32 tensors on `device` (the GPU unless
    device="cpu")."""
    dev = resolve_device(device)
    return BAProblem(*(f32_tensor(a, dev) for a in (poses_cw, points_w, K, observations, mask)))


def build_window_problem(
    poses_wc: np.ndarray,
    depths: np.ndarray,
    K: np.ndarray,
    step: int = 8,
    obs_noise: np.ndarray | None = None,
    device=None,
) -> BAProblem:
    """Construct a BA window from per-keyframe poses + depths.

    Landmarks: grid-backprojected from every keyframe (owner frame).
    Observations: landmarks projected into every window frame, masked to
    the image bounds and positive depth. `obs_noise` (the observations'
    shape) injects measurement noise for tests.

    poses_wc: (M, 4, 4) cam-to-world; depths: (M, H, W).
    """
    M = len(poses_wc)
    H, W = depths[0].shape
    pts = np.concatenate(
        [sample_grid_landmarks(depths[i], K, poses_wc[i], step) for i in range(M)], axis=0
    )
    poses_cw = np.linalg.inv(poses_wc)
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    p_c = np.einsum("mij,nj->mni", R, pts) + t[:, None, :]
    z = p_c[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * p_c[..., 0] / z + K[0, 2]
        v = K[1, 1] * p_c[..., 1] / z + K[1, 2]
    obs = np.stack([u, v], -1)
    mask = ((z > 0.1) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)).astype(np.float32)
    obs = np.nan_to_num(obs)
    if obs_noise is not None:
        obs = obs + obs_noise
    return problem_from_numpy(poses_cw, pts, K, obs, mask, device)


class SlidingWindowBA:
    """Refine a full trajectory window by window, on `device` (the GPU
    unless device="cpu").

    For each window of `cfg.window_size` keyframes (stride = size//2),
    runs damped GN and writes the refined poses back; overlapping windows
    chain by anchoring each window's first two poses to the
    already-refined trajectory (the gauge of `solve_window`).
    """

    def __init__(self, cfg: BAConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def refine_trajectory(
        self,
        poses_wc: np.ndarray,
        depths: np.ndarray,
        K: np.ndarray,
        grid_step: int = 8,
        obs_noise_fn=None,
        obs_poses: np.ndarray | None = None,
    ) -> np.ndarray:
        """Refine `poses_wc` window by window.

        Observations must be MEASUREMENTS independent of the poses being
        refined, or every residual is zero by construction. `obs_poses`
        supplies the poses that project the landmark observations (e.g.
        a synthetic world's GT as an oracle); it defaults to `poses_wc`
        with a warning, so accidental self-consistency is visible.
        """
        exact_f32()
        if obs_poses is None:
            warnings.warn(
                "refine_trajectory: observations projected from the poses "
                "being refined are self-consistent (zero residual) — pass "
                "obs_poses or flow tracks",
                stacklevel=2,
            )
            obs_poses = poses_wc
        M = self.cfg.window_size
        out = poses_wc.copy()
        for start in window_starts(len(out), M, max(M // 2, 1)):
            end = min(start + M, len(out))
            if end - start < 3:
                break
            noise = obs_noise_fn(end - start) if obs_noise_fn else None
            prob = build_window_problem(
                obs_poses[start:end], depths[start:end], K, grid_step, noise, self.device
            )
            # Start from the trajectory being refined; its first two
            # poses anchor the window (gauge).
            prob = prob._replace(poses_cw=f32_tensor(np.linalg.inv(out[start:end]), self.device))
            refined = ba_refine(prob, self.cfg)
            out[start + 2 : end] = np.linalg.inv(refined.poses_cw.cpu().numpy())[2:]
        return out
