"""Image warping: bilinear sampling, projective inverse warp, flow warps
(port of davo_tpu.core.warp). NHWC.

`bilinear_sample` has the reference's gather methods:
- "take4": four gathered taps per pixel (the reference's exact XLA
  gather), in plain PyTorch; autograd gives its gradients.
- "block": the reference's (2, 2, C)-block gather, which it documents as
  identical to take4 in value and weights; here it runs take4.
- "banded": the banded warp of `kernels/bandwarp.py` (a hand-written
  CUDA kernel on the GPU), exact inside the displacement band and
  band-edge clamped beyond, with the TPU kernel's own backward.
The process-wide default is "take4" (or DAVO_WARP_GATHER); the training
loop sets it from `TrainConfig.warp_gather` through `configure`, as the
reference does.

`flow_warp_separable` is kept as the reference writes it: two banded
one-hot matmul passes, the second of which evaluates du at row h instead
of row y. That approximation is part of the model's function, so it is
reproduced, not replaced by an exact `grid_sample`.
"""

from __future__ import annotations

import os

import torch

from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.core.geometry import clip, pixel_grid
from davo_tpu_torch.kernels.bandwarp import banded_warp

GATHER_METHODS = ("take4", "block", "banded")
_DEFAULT_GATHER = os.environ.get("DAVO_WARP_GATHER", "take4")
_BAND = tuple(int(t) for t in os.environ.get("DAVO_WARP_BAND", "4,16").split(","))


def configure(gather: str | None = None, band: tuple[int, int] | None = None) -> None:
    """Set the process-wide default gather method and clamp band (rv,
    rh); None leaves a value as it is."""
    global _DEFAULT_GATHER, _BAND
    if gather is not None:
        if gather not in GATHER_METHODS:
            raise ValueError(f"unknown gather {gather!r}; have {GATHER_METHODS}")
        _DEFAULT_GATHER = gather
    if band is not None:
        _BAND = tuple(band)


def bilinear_sample(
    img: torch.Tensor, coords: torch.Tensor, fill: str = "zeros", method: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample img (B, H, W, C) at pixel coordinates coords (B, Ho, Wo, 2)
    = (u, v). fill="zeros" zeroes out-of-frame samples, "border" keeps
    the edge-clamped sample (the loss path). Returns (sampled (B, Ho, Wo,
    C), valid (B, Ho, Wo, 1) in {0, 1})."""
    m = method or _DEFAULT_GATHER
    if m == "banded":
        return banded_warp(img, coords, rv=_BAND[0], rh=_BAND[1], fill=fill)
    if m not in GATHER_METHODS:
        raise ValueError(f"unknown gather {m!r}; have {GATHER_METHODS}")
    return _bilinear_sample_take4(img, coords, fill)


def _bilinear_sample_take4(
    img: torch.Tensor, coords: torch.Tensor, fill: str
) -> tuple[torch.Tensor, torch.Tensor]:
    B, H, W, C = img.shape
    u, v = coords[..., 0], coords[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0))[..., None].to(img.dtype)

    u0c, v0c = u0.clamp(0, W - 1).long(), v0.clamp(0, H - 1).long()
    u1c, v1c = (u0 + 1).clamp(0, W - 1).long(), (v0 + 1).clamp(0, H - 1).long()
    flat = img.reshape(B, H * W, C)

    def gather(vi, ui):
        idx = vi * W + ui
        taps = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return taps.reshape(idx.shape + (C,))

    top = gather(v0c, u0c) * (1.0 - du) + gather(v0c, u1c) * du
    bot = gather(v1c, u0c) * (1.0 - du) + gather(v1c, u1c) * du
    out = top * (1.0 - dv) + bot * dv
    if fill == "border":
        return out, valid
    return out * valid, valid


def projective_inverse_warp(
    src: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor, K: torch.Tensor,
    rotation: str = "euler", fill: str = "zeros",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct the target view by sampling src (B, H, W, C) through
    target depth (B, H, W) and the target->source pose ((B, 6) vector or
    (B, 4, 4)), K (B, 3, 3). Points behind the source camera are invalid.
    Returns (warped (B, H, W, C), valid (B, H, W, 1))."""
    T = geo.pose_vec_to_mat(pose, rotation=rotation) if pose.dim() == 2 else pose
    uv, z = geo.cam_to_pixel(geo.pixel_to_cam(depth, K), K, T)
    warped, valid = bilinear_sample(src, uv.movedim(-3, -1), fill=fill)
    valid = valid * (z > 0.0)[..., None].to(valid.dtype)
    if fill == "border":
        return warped, valid
    return warped * valid, valid


def flow_warp(
    src: torch.Tensor, flow: torch.Tensor, fill: str = "zeros"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp src (B, H, W, C) by a dense flow (B, H, W, 2) = (du, dv):
    sample src at (u + du, v + dv) through `bilinear_sample`."""
    _, H, W, _ = src.shape
    grid = pixel_grid(H, W, src.dtype, src.device)[:2]
    return bilinear_sample(src, grid.movedim(0, -1)[None] + flow, fill=fill)


def flow_warp_separable(
    src: torch.Tensor, flow: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp `src` (B, H, W, C) by `flow` (B, H, W, 2) = (du, dv).

      pass 1 (exact):  mid[b,y,x] = sum_w Wx[b,y,x,w] src[b,y,w]
      pass 2:          out[b,y,x] = sum_h Wy[b,y,x,h] mid[b,h,x]

    with hat weights relu(1 - |i - coord|), in the source dtype. Use at
    pyramid resolution only: the weights are (B,H,W,W) and (B,H,W,H).
    Returns (warped * valid, valid), valid (B, H, W, 1) in src's dtype.
    """
    B, H, W, C = src.shape
    dt = src.dtype
    grid = pixel_grid(H, W, torch.float32, src.device)
    u = grid[0][None] + flow[..., 0]
    v = grid[1][None] + flow[..., 1]
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0))[..., None].to(dt)
    uc = clip(u, 0.0, W - 1.0)
    vc = clip(v, 0.0, H - 1.0)

    xs = torch.arange(W, dtype=torch.float32, device=src.device)
    wx = torch.relu(1.0 - (xs - uc[..., None]).abs()).to(dt)
    mid = torch.einsum("byxw,bywc->byxc", wx, src)

    hs = torch.arange(H, dtype=torch.float32, device=src.device)
    wy = torch.relu(1.0 - (hs - vc[..., None]).abs()).to(dt)
    out = torch.einsum("byxh,bhxc->byxc", wy, mid)
    return out * valid, valid
