"""Reprojection residuals and closed-form Jacobians (port of
davo_tpu.ba.residuals).

Conventions:
* Poses are world->camera transforms T_cw (4, 4): p_c = R p_w + t (the
  inverse of the cam-to-world trajectory poses; `window.py` converts).
* Landmarks are world points (N, 3).
* Observations are pixel coords (M, N, 2) with mask (M, N).
* Pose updates are LEFT multiplicative: T <- exp(delta_xi) T, so the
  pose Jacobian of a camera point is d p_c / d xi = [I | -hat(p_c)].
"""

from __future__ import annotations

import torch

from davo_tpu_torch.core import geometry as geo

_EPS = 1e-9


def _camera_points(poses_cw: torch.Tensor, points_w: torch.Tensor) -> torch.Tensor:
    """(M, N, 3) camera-frame points."""
    return torch.einsum("mij,nj->mni", poses_cw[:, :3, :3], points_w) + poses_cw[:, None, :3, 3]


def project_points(
    poses_cw: torch.Tensor, points_w: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project all landmarks into all keyframes.

    poses_cw: (M, 4, 4); points_w: (N, 3); K: (3, 3).
    Returns (pixels (M, N, 2), cam-z (M, N)).
    """
    p_c = _camera_points(poses_cw, points_w)
    z = p_c[..., 2]
    z_safe = torch.where(z.abs() < _EPS, _EPS, z)
    u = K[0, 0] * p_c[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * p_c[..., 1] / z_safe + K[1, 2]
    return torch.stack([u, v], -1), z


def reprojection_residuals(
    poses_cw: torch.Tensor,
    points_w: torch.Tensor,
    K: torch.Tensor,
    observations: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Masked residuals (M, N, 2): predicted - observed (0 where unseen
    or behind the camera)."""
    pix, z = project_points(poses_cw, points_w, K)
    valid = (mask > 0) & (z > _EPS)
    return torch.where(valid[..., None], pix - observations, 0.0)


def reprojection_jacobians(
    poses_cw: torch.Tensor,
    points_w: torch.Tensor,
    K: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form Jacobians of the residual.

    Returns (J_pose (M, N, 2, 6), J_point (M, N, 2, 3)), zeroed where
    masked/behind-camera. With p_c the camera-frame point:

      d r / d p_c = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
      d p_c / d xi = [I | -hat(p_c)]   (left-mult twist [v, w])
      d p_c / d p_w = R
    """
    R = poses_cw[:, :3, :3]
    p_c = _camera_points(poses_cw, points_w)
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    valid = (mask > 0) & (z > _EPS)
    inv_z = 1.0 / torch.where(z < _EPS, 1.0, z)
    fx, fy = K[0, 0], K[1, 1]
    zero = torch.zeros_like(x)
    dr_dpc = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
        ],
        -2,
    )  # (M, N, 2, 3)
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -geo.so3_hat(p_c)], -1)  # (M, N, 3, 6)
    J_pose = torch.einsum("mnij,mnjk->mnik", dr_dpc, dpc_dxi)
    J_point = torch.einsum("mnij,mjk->mnik", dr_dpc, R)
    vmask = valid[..., None, None]
    return torch.where(vmask, J_pose, 0.0), torch.where(vmask, J_point, 0.0)


def huber_weights(
    residuals: torch.Tensor, delta: float, cutoff: float | None = None
) -> torch.Tensor:
    """IRLS weights: Huber, truncated at `cutoff` px.

    Pure Huber keeps a constant-slope pull from gross outliers; with free
    structure and few pose anchors that pull bends the window even as the
    cost decreases. The truncation gates them out once they exceed
    `cutoff`, the classic truncated robust loss.
    """
    norm = torch.linalg.norm(residuals, dim=-1)
    w = torch.where(norm <= delta, 1.0, delta / torch.clamp_min(norm, _EPS))
    if cutoff is not None:
        w = torch.where(norm > cutoff, 0.0, w)
    return w
