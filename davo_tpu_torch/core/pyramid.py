"""Image pyramids (port of davo_tpu.core.pyramid). NHWC.

The multi-scale photometric loss evaluates warps at /2 pyramid levels;
each level is a 2x2 average pool of the one above.
"""

from __future__ import annotations

import torch

from davo_tpu_torch.kernels.resize import resize_bilinear as _resize_bilinear


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool over (B, H, W, C), VALID: an odd last row or
    column is dropped, as `lax.reduce_window` does."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    total = x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]
    return total * 0.25


def image_pyramid(x: torch.Tensor, num_scales: int) -> list[torch.Tensor]:
    """[full-res, /2, /4, ...]: `num_scales` levels of (B, H, W, C)."""
    levels = [x]
    for _ in range(num_scales - 1):
        levels.append(downsample2(levels[-1]))
    return levels


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize (B, H, W, C) -> (B, height, width, C), antialiased
    when it shrinks, as `jax.image.resize(..., "bilinear")`."""
    return _resize_bilinear(x, height, width)
