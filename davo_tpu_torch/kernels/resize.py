"""Bilinear upsampling by integer factors (port of davo_tpu.kernels.resize).

Half-pixel centers with an edge clamp, written as shifts, lerps and an
interleave exactly as the reference writes it, so the two agree to
rounding. Matches `jax.image.resize(..., method="bilinear")` for integer
factors. NHWC.
"""

from __future__ import annotations

import torch


def _upsample_axis(x: torch.Tensor, axis: int, factor: int) -> torch.Tensor:
    """Bilinear x`factor` upsample along `axis`, half-pixel centers."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    prev = torch.cat([first, x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), last], axis)
    phases = []
    for j in range(factor):
        frac = (j + 0.5) / factor - 0.5
        if frac < 0:
            phases.append((-frac) * prev + (1.0 + frac) * x)
        else:
            phases.append((1.0 - frac) * x + frac * nxt)
    stacked = torch.stack(phases, axis + 1)
    shape = list(x.shape)
    shape[axis] = n * factor
    return stacked.reshape(shape)


def upsample2x_bilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, f*H, f*W, C) bilinear, half-pixel centers."""
    return _upsample_axis(_upsample_axis(x, 1, factor), 2, factor)


def resize_bilinear_aligned(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Integer-factor bilinear resize. The reference falls back to
    `jax.image.resize` for other sizes, which no shape of the ported
    slice reaches; that fallback is not ported yet."""
    _, H, W, _ = x.shape
    if height % H == 0 and width % W == 0 and height // H == width // W:
        return upsample2x_bilinear(x, factor=height // H)
    raise NotImplementedError(
        f"non-integer bilinear resize {H}x{W} -> {height}x{width} is not ported yet"
    )
