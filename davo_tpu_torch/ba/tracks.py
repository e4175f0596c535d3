"""Flow-tracked BA observations (port of davo_tpu.ba.tracks; SURVEY.md
§2.2 P6, BASELINE #4).

`SlidingWindowBA` needs observations that are MEASUREMENTS independent of
the poses being refined. This module supplies them from optical flow:
sparse grid landmarks in a window's anchor frame are chained through
consecutive-frame flows (bilinear lookup of the flow at each tracked
position), gated by forward-backward consistency, and handed to
`BAProblem` as pixel observations. The landmarks start as the anchor
grid backprojected through the anchor depth map; Gauss-Newton then
refines poses AND landmarks, so depth noise is absorbed by the landmark
block.

Flow convention (models/flownet.py): the flow from net(img_i, img_j)
maps a pixel p of frame i to p + flow[p] in frame j.

Tracking is host numpy (O(1e3) tracks per window); the flow fields come
from the flow net on the device (`make_flow_fn`), the solve from
`ba_refine` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from davo_tpu_torch import exact_f32, resolve_device
from davo_tpu_torch.ba.gn import BAProblem, ba_refine
from davo_tpu_torch.ba.window import problem_from_numpy, window_starts
from davo_tpu_torch.config import BAConfig


def bilinear_at(field: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Sample (H, W, C) at float pixel coords uv (N, 2) -> (N, C)."""
    H, W = field.shape[:2]
    u = np.clip(uv[:, 0], 0.0, W - 1.000001)
    v = np.clip(uv[:, 1], 0.0, H - 1.000001)
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    f00 = field[v0, u0]
    f01 = field[v0, u0 + 1]
    f10 = field[v0 + 1, u0]
    f11 = field[v0 + 1, u0 + 1]
    return (
        f00 * (1 - fu) * (1 - fv)
        + f01 * fu * (1 - fv)
        + f10 * (1 - fu) * fv
        + f11 * fu * fv
    )


def track_window(
    flows_fwd: np.ndarray,
    flows_bwd: np.ndarray,
    uv0: np.ndarray,
    fb_px: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Chain per-pair flows across a window from anchor pixels uv0.

    flows_fwd: (M-1, H, W, 2), flow i -> i+1 at frame-i pixels
    flows_bwd: (M-1, H, W, 2), flow i+1 -> i at frame-(i+1) pixels
    uv0:       (N, 2) anchor-frame pixels

    Returns (obs (M, N, 2), valid (M, N)). A track dies (valid=0 from
    that frame on) when it leaves the image or fails the forward-backward
    round trip |p + f_fwd(p) + f_bwd(p')| > fb_px, the standard
    occlusion / bad-match gate.
    """
    M = len(flows_fwd) + 1
    H, W = flows_fwd.shape[1:3]
    obs = [uv0.astype(np.float64)]
    valid = [np.ones(len(uv0), bool)]
    uv = uv0.astype(np.float64)
    for i in range(M - 1):
        uv_next = uv + bilinear_at(flows_fwd[i], uv)
        back = bilinear_at(flows_bwd[i], uv_next)
        roundtrip = np.linalg.norm(uv_next + back - uv, axis=-1)
        inb = (
            (uv_next[:, 0] >= 0)
            & (uv_next[:, 0] <= W - 1)
            & (uv_next[:, 1] >= 0)
            & (uv_next[:, 1] <= H - 1)
        )
        obs.append(uv_next)
        valid.append(valid[-1] & inb & (roundtrip <= fb_px))
        uv = uv_next
    return np.stack(obs), np.stack(valid)


def anchor_grid(
    H: int,
    W: int,
    step: int,
    seg: np.ndarray | None = None,
    exclude_labels: tuple = (),
) -> np.ndarray:
    """Sparse anchor pixels (N, 2); optionally drop semantic classes
    (e.g. the dynamic ids: independently moving objects violate the
    rigid-scene BA model)."""
    vs, us = np.mgrid[step // 2 : H : step, step // 2 : W : step]
    uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float64)
    if seg is not None and exclude_labels:
        labels = seg[uv[:, 1].astype(int), uv[:, 0].astype(int)]
        uv = uv[~np.isin(labels, exclude_labels)]
    return uv


def build_tracked_problem(
    poses_wc_init: np.ndarray,
    depth0: np.ndarray,
    K: np.ndarray,
    obs: np.ndarray,
    valid: np.ndarray,
    device=None,
) -> BAProblem:
    """Assemble a BAProblem from tracked observations, on `device` (the
    GPU unless device="cpu").

    Landmarks: anchor-frame pixels obs[0] backprojected through depth0
    and poses_wc_init[0] (refined further by GN's landmark block). Built
    in float64 on the host, then cast to float32, as the reference.
    """
    uv0 = obs[0]
    z = bilinear_at(depth0[..., None], uv0)[:, 0]
    x = (uv0[:, 0] - K[0, 2]) / K[0, 0] * z
    y = (uv0[:, 1] - K[1, 2]) / K[1, 1] * z
    p_c = np.stack([x, y, z], -1)
    C0 = poses_wc_init[0]
    pts_w = (C0[:3, :3] @ p_c.T).T + C0[:3, 3]
    return problem_from_numpy(np.linalg.inv(poses_wc_init), pts_w, K, obs, valid, device)


def refine_trajectory_tracked(
    cfg: BAConfig,
    poses_wc: np.ndarray,
    depths: np.ndarray,
    K: np.ndarray,
    flow_fn,
    grid_step: int = 8,
    fb_px: float = 1.0,
    segs: np.ndarray | None = None,
    exclude_labels: tuple = (),
    device=None,
) -> np.ndarray:
    """Window-by-window BA with flow-tracked observations, solved on
    `device` (the GPU unless device="cpu").

    flow_fn(i, j) -> (H, W, 2) flow from frame i to frame j (see
    `make_flow_fn` for the net-backed one). No GT oracle anywhere: the
    observations are measurements from the flow field alone.
    """
    exact_f32()
    dev = resolve_device(device)
    M = cfg.window_size
    out = poses_wc.copy()
    H, W = depths[0].shape
    for start in window_starts(len(out), M, max(M // 2, 1)):
        end = min(start + M, len(out))
        if end - start < 3:
            break
        idx = list(range(start, end))
        flows_fwd = np.stack([flow_fn(i, i + 1) for i in idx[:-1]])
        flows_bwd = np.stack([flow_fn(i + 1, i) for i in idx[:-1]])
        seg0 = segs[start] if segs is not None else None
        uv0 = anchor_grid(H, W, grid_step, seg0, exclude_labels)
        if len(uv0) < 8:
            continue
        obs, valid = track_window(flows_fwd, flows_bwd, uv0, fb_px)
        # Landmarks seen in < 2 frames constrain nothing.
        keep = valid.sum(0) >= 2
        if keep.sum() < 8:
            continue
        prob = build_tracked_problem(
            out[start:end], depths[start], K, obs[:, keep], valid[:, keep], dev
        )
        refined = ba_refine(prob, cfg)
        # Inverted in float32, as the reference inverts its float32 array.
        out[start + 2 : end] = np.linalg.inv(refined.poses_cw.cpu().numpy())[2:]
    return out


def make_flow_fn(model, frames: np.ndarray):
    """Net-backed flow source for `refine_trajectory_tracked`.

    Runs the `flownet` submodule of a `DavoModel` (e.g. one restored from
    a checkpoint: the submodule that produced the training flows) on one
    frame pair at a time, on the model's device, and upsamples the finest
    level to full resolution (`FlowNetLite.full_res_flow`). Results are
    cached per (i, j) as numpy (H, W, 2).
    """
    from davo_tpu_torch.models.flownet import FlowNetLite

    fnet = model.flownet
    device = next(fnet.parameters()).device
    H, W = frames.shape[1:3]
    cache: dict = {}

    def flow_fn(i: int, j: int) -> np.ndarray:
        if (i, j) not in cache:
            with torch.inference_mode():
                img_i = torch.as_tensor(frames[i], dtype=torch.float32).to(device)
                img_j = torch.as_tensor(frames[j], dtype=torch.float32).to(device)
                pyr = fnet(img_i[None], img_j[None])
                cache[(i, j)] = FlowNetLite.full_res_flow(pyr[0], H, W)[0].cpu().numpy()
        return cache[(i, j)]

    return flow_fn
