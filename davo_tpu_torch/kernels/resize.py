"""Bilinear resize (port of davo_tpu.kernels.resize). NHWC.

Integer factors: half-pixel centers with an edge clamp, written as
shifts, lerps and an interleave exactly as the reference writes it, so
the two agree to rounding. Any other size: `resize_bilinear`, the
computation of `jax.image.resize(..., method="bilinear")` (antialiased
when it shrinks), which the reference falls back to.
"""

from __future__ import annotations

import functools

import torch

from davo_tpu_torch import exact_f32


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


@functools.lru_cache(maxsize=64)
def _weight_mat(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis, as JAX's
    `compute_weight_mat` forms them for the triangle kernel: sample
    positions (o + 0.5) / scale - 0.5, the kernel widened by
    max(1 / scale, 1) (antialiasing when it shrinks), each column divided
    by its sum (zeroed where the sum is at most 1000 float32 eps), and
    columns whose sample lies outside [-0.5, n_in - 0.5] zeroed.

    A sample position is rounded to float32 once, from (o + 0.5) times
    the float32 1 / scale and less 0.5, as the fused multiply-add that
    XLA compiles it to gives it: far from the origin the twice-rounded
    position lies an ulp off (3.8e-6 of a weight at 83 -> 330)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    inv32 = float(torch.tensor(inv_scale, dtype=torch.float32))
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv32 - 0.5).float()
    taps = torch.arange(n_in, dtype=torch.float32, device=device)
    dist = (sample[None, :] - taps[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - dist, min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(
        total.abs() > 1000.0 * eps, weights / torch.where(total != 0, total, 1.0), 0.0
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(x, (B, height, width, C), "bilinear")` on NHWC
    `x`: one dense weight matrix per axis that changes size, contracted
    in x's dtype (float32 with TF32 off on the GPU). Not
    `F.interpolate(antialias=True)`, whose shrinking filter differs."""
    _, H, W, _ = x.shape
    if x.is_cuda:
        exact_f32()
    if H != height:
        x = torch.einsum("bhwc,hy->bywc", x, _weight_mat(H, height, x.device).to(x.dtype))
    if W != width:
        x = torch.einsum("bywc,wx->byxc", x, _weight_mat(W, width, x.device).to(x.dtype))
    return x


def resize_bilinear_aligned(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Integer-factor fast path, else `resize_bilinear` (the reference's
    `jax.image.resize` fallback)."""
    _, H, W, _ = x.shape
    if height % H == 0 and width % W == 0 and height // H == width // W:
        return upsample2x_bilinear(x, factor=height // H)
    return resize_bilinear(x, height, width)
