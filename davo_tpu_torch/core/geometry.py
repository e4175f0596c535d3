"""Pose vectors, rigid transforms, camera projection and trajectory
algebra (subset of davo_tpu.core.geometry: what streaming pose inference
and the photometric train step use).

The 6-vector convention is the reference's ``[tx, ty, tz, rx, ry, rz]``
with Euler angles and R = Rz @ Ry @ Rx. All functions broadcast over
leading batch dimensions and run in the input's dtype (float32 here).
"""

from __future__ import annotations

import torch

from davo_tpu_torch import exact_f32

_EPS = 1e-8


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with JAX's gradient: at an exact tie with a bound half
    the gradient passes (JAX's max/min split ties evenly; `torch.clamp`
    passes all of it). Use wherever the reference clips a value that
    carries a gradient."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def euler_to_mat(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles ``[rx, ry, rz]`` (radians) -> rotation (..., 3, 3),
    R = Rz(rz) @ Ry(ry) @ Rx(rx) in closed form."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def mat_to_euler(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> Euler ``[rx, ry, rz]`` (R = Rz Ry Rx),
    gimbal-safe by clipping; valid for |ry| < pi/2."""
    sy = clip(-rot[..., 2, 0], -1.0 + 1e-7, 1.0 - 1e-7)
    ry = torch.asin(sy)
    rx = torch.atan2(rot[..., 2, 1], rot[..., 2, 2])
    rz = torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    return torch.stack([rx, ry, rz], -1)


def pose_vec_to_mat(vec: torch.Tensor, rotation: str = "euler") -> torch.Tensor:
    """6-DoF ``[tx, ty, tz, rx, ry, rz]`` -> homogeneous (..., 4, 4)."""
    if rotation != "euler":
        raise NotImplementedError(f"rotation={rotation!r} is not ported yet")
    return rt_to_mat(euler_to_mat(vec[..., 3:6]), vec[..., :3])


def mat_to_pose_vec(mat: torch.Tensor, rotation: str = "euler") -> torch.Tensor:
    """Homogeneous (..., 4, 4) -> ``[tx, ty, tz, rx, ry, rz]``."""
    if rotation != "euler":
        raise NotImplementedError(f"rotation={rotation!r} is not ported yet")
    return torch.cat([mat[..., :3, 3], mat_to_euler(mat[..., :3, :3])], -1)


def rt_to_mat(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], -2)


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates, shape (3, H, W): rows (u, v, 1)."""
    u = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return torch.stack([u, v, torch.ones_like(u)], 0)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale intrinsics for an image resized by (sx, sy)."""
    scale = torch.tensor(
        [[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]], dtype=K.dtype, device=K.device
    )
    return K * scale


def intrinsics_pyramid(K: torch.Tensor, num_scales: int) -> list[torch.Tensor]:
    """Per-scale intrinsics for a /2 image pyramid (scale 0 = full res)."""
    return [scale_intrinsics(K, 0.5**s, 0.5**s) for s in range(num_scales)]


def pixel_to_cam(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project depth (..., H, W) through K (..., 3, 3) -> camera
    points (..., 3, H, W)."""
    h, w = depth.shape[-2], depth.shape[-1]
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("...ij,jhw->...ihw", torch.linalg.inv(K), grid)
    return rays * depth[..., None, :, :]


def cam_to_pixel(
    points: torch.Tensor, K: torch.Tensor, T: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform camera points (..., 3, H, W) by T (..., 4, 4) and
    project with K -> (pixel uv (..., 2, H, W), depth z (..., H, W)).
    |z| < 1e-8 divides by 1e-8, as the reference's `z_safe`."""
    rot = T[..., :3, :3]
    t = T[..., :3, 3]
    p = torch.einsum("...ij,...jhw->...ihw", rot, points) + t[..., :, None, None]
    proj = torch.einsum("...ij,...jhw->...ihw", K, p)
    z = proj[..., 2, :, :]
    z_safe = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return proj[..., :2, :, :] / z_safe[..., None, :, :], z


def trajectory_from_relatives(
    rel_mats: torch.Tensor, T0: torch.Tensor | None = None
) -> torch.Tensor:
    """(N, 4, 4) increments -> (N+1, 4, 4) absolute poses with
    poses[0] = T0 (identity by default), poses[k+1] = poses[k] @ rel[k].

    An inclusive prefix product in log2(N) doubling steps (Hillis-Steele),
    the counterpart of the reference's associative scan; it agrees with
    a sequential chain up to rounding.
    """
    exact_f32()
    eye = torch.eye(4, dtype=rel_mats.dtype, device=rel_mats.device)
    chained = rel_mats
    step = 1
    while step < len(chained):
        chained = torch.cat([chained[:step], chained[:-step] @ chained[step:]], 0)
        step *= 2
    poses = torch.cat([eye[None], chained], 0)
    return poses if T0 is None else T0[None] @ poses
