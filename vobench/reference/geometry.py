"""Camera geometry of the photometric losses, in plain PyTorch: Euler
pose vectors, back-projection and projection (SfMLearner's convention:
``[tx, ty, tz, rx, ry, rz]``, R = Rz Ry Rx, the pose maps target-camera
points into the source camera)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def pose_vec_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4)."""
    rx, ry, rz = vec[..., 3], vec[..., 4], vec[..., 5]
    cx, sx, cy, sy, cz, sz = torch.cos(rx), torch.sin(rx), torch.cos(ry), torch.sin(ry), torch.cos(rz), torch.sin(rz)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    rot = torch.stack([torch.stack(r, -1) for r in rows], -2)
    t = vec[..., :3]
    top = torch.cat([rot, t[..., :, None]], -1)
    zero = torch.zeros_like(t[..., :1])
    bottom = torch.cat([zero, zero, zero, torch.ones_like(zero)], -1)[..., None, :]
    return torch.cat([top, bottom], -2)


def pixel_grid(height: int, width: int, device) -> torch.Tensor:
    """(3, H, W): rows u, v, 1."""
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width)
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    return torch.stack([u, v, torch.ones_like(u)], 0)


def intrinsics_pyramid(K: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """K of each /2 level: fx, cx scaled by 2^-s along x; fy, cy along y."""
    out = []
    for s in range(levels):
        f = 0.5**s
        scale = torch.tensor([[f, 1.0, f], [1.0, f, f], [1.0, 1.0, 1.0]], dtype=K.dtype, device=K.device)
        out.append(K * scale)
    return out


def pixel_to_cam(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W), K (B, 3, 3) -> points (B, 3, H, W)."""
    grid = pixel_grid(depth.shape[-2], depth.shape[-1], depth.device)
    rays = torch.einsum("bij,jhw->bihw", torch.linalg.inv(K), grid)
    return rays * depth[:, None]


def cam_to_pixel(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor):
    """points (B, 3, H, W) moved by T (B, 4, 4), projected by K ->
    (uv (B, 2, H, W), z (B, H, W)); |z| < 1e-8 divides by 1e-8."""
    p = torch.einsum("bij,bjhw->bihw", T[:, :3, :3], points) + T[:, :3, 3][:, :, None, None]
    proj = torch.einsum("bij,bjhw->bihw", K, p)
    z = proj[:, 2]
    z_safe = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return proj[:, :2] / z_safe[:, None], z
