"""Flow warping (subset of davo_tpu.core.warp: the pyramid warp of the
flow net).

`flow_warp_separable` is kept as the reference writes it: two banded
one-hot matmul passes, the second of which evaluates du at row h instead
of row y. That approximation is part of the model's function, so it is
reproduced, not replaced by an exact `grid_sample`.
"""

from __future__ import annotations

import torch

from davo_tpu_torch.core.geometry import pixel_grid


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
    uc = u.clamp(0.0, W - 1.0)
    vc = v.clamp(0.0, H - 1.0)

    xs = torch.arange(W, dtype=torch.float32, device=src.device)
    wx = torch.relu(1.0 - (xs - uc[..., None]).abs()).to(dt)
    mid = torch.einsum("byxw,bywc->byxc", wx, src)

    hs = torch.arange(H, dtype=torch.float32, device=src.device)
    wy = torch.relu(1.0 - (hs - vc[..., None]).abs()).to(dt)
    out = torch.einsum("byxh,bhxc->byxc", wy, mid)
    return out * valid, valid
