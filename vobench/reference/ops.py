"""Plain PyTorch operations of the DAVO model and its training losses.

A frozen, independent statement of the arithmetic the benchmarked
program computes: NHWC tensors, float32 throughout, no hand-written
kernel, no cache, no fused path. `Precision` says where the compute
precision of a configuration rounds: identity for the reference itself
("float32"); "bfloat16" or "fp8" (e4m3, saturating at +-448) round each
convolution's operands and output as a lower-precision program would,
which makes the control of the benchmark's correctness check; fp8
rounds the forward only, its gradients stay float32.

Imports nothing of the benchmarked program.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    """Where compute rounds: `q(x)` rounds a float32 tensor to the
    precision and returns it as float32."""

    def __init__(self, name: str):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        # Rounded forward, float32 gradient (a straight-through cast):
        # autograd through the cast itself would round every gradient to
        # fp8 and flush the small ones to zero.
        return x + (x.detach().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() - x.detach())


def exact_float32() -> None:
    """Float32 means float32 on the card: no TF32 in cuDNN's convolutions
    or cuBLAS's products (PyTorch lets cuDNN use TF32 by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding: output ceil(size / stride), the smaller half
    of the total padding low."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int, p: Precision) -> torch.Tensor:
    """SAME convolution of NHWC `x` with OIHW `weight`; the operands and
    the output rounded by `p`, then the rounded bias added and rounded."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (same_pads(n, k, stride) for n in x.shape[1:3])
    xp = F.pad(p.q(x), (0, 0, left, right, top, bottom))
    y = F.conv2d(xp.permute(0, 3, 1, 2), p.q(weight), stride=stride).permute(0, 2, 3, 1)
    return p.q(p.q(y) + p.q(bias))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip with half the gradient at a tie (max then min)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


# --------------------------------------------------------------------------
# Resizing
# --------------------------------------------------------------------------


def _upsample_axis(x: torch.Tensor, axis: int, factor: int) -> torch.Tensor:
    """Bilinear x`factor` along `axis`: half-pixel centres, edge clamp."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    phases = []
    for j in range(factor):
        frac = (j + 0.5) / factor - 0.5
        phases.append((-frac) * prev + (1.0 + frac) * x if frac < 0 else (1.0 - frac) * x + frac * nxt)
    shape = list(x.shape)
    shape[axis] = n * factor
    return torch.stack(phases, axis + 1).reshape(shape)


@functools.lru_cache(maxsize=32)
def _weight_mat(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) triangle-kernel weights of a bilinear resize along
    one axis, widened by the shrink factor (antialiasing), columns
    normalised, samples outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    inv32 = float(torch.tensor(inv_scale, dtype=torch.float32))
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv32 - 0.5).float()
    taps = torch.arange(n_in, dtype=torch.float32, device=device)
    weights = torch.clamp(1.0 - (sample[None, :] - taps[:, None]).abs() / kernel_scale, min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC `x`, antialiased when it shrinks."""
    _, H, W, _ = x.shape
    if H != height:
        x = torch.einsum("bhwc,hy->bywc", x, _weight_mat(H, height, x.device))
    if W != width:
        x = torch.einsum("bywc,wx->byxc", x, _weight_mat(W, width, x.device))
    return x


def resize_aligned(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Integer-factor upsample by lerps where the factor is the same on
    both axes, else `resize_bilinear`."""
    _, H, W, _ = x.shape
    if height % H == 0 and width % W == 0 and height // H == width // W:
        f = height // H
        return _upsample_axis(_upsample_axis(x, 1, f), 2, f)
    return resize_bilinear(x, height, width)


def upsample_nearest_crop(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest 2x upsample of NHWC `x`, cropped to `hw`."""
    B, H, W, C = x.shape
    up = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
    return up[:, : hw[0], : hw[1]]


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, VALID."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) * 0.25


def image_pyramid(x: torch.Tensor, levels: int) -> list[torch.Tensor]:
    out = [x]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return out


# --------------------------------------------------------------------------
# Correlation and warps
# --------------------------------------------------------------------------


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    """out[b, h, w, k] = mean_c f1[b, h, w, c] * f2[b, h + dy, w + dx, c]
    over the (2s+1)^2 shifts, dy-major; f2 outside the frame is 0."""
    B, H, W, C = f1.shape
    f2p = F.pad(f2, (0, 0, search, search, search, search))
    d = 2 * search + 1
    return torch.stack(
        [(f1 * f2p[:, dy : dy + H, dx : dx + W]).mean(-1) for dy in range(d) for dx in range(d)], -1
    )


def flow_warp_separable(src: torch.Tensor, flow: torch.Tensor, p: Precision) -> torch.Tensor:
    """The flow net's separable warp: a pass of hat weights along x at
    row y, then along y at column x, each rounded by `p`; times the
    in-frame mask."""
    B, H, W, C = src.shape
    u = torch.arange(W, dtype=torch.float32, device=src.device)[None, None, :] + flow[..., 0]
    v = torch.arange(H, dtype=torch.float32, device=src.device)[None, :, None] + flow[..., 1]
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0))[..., None].float()
    uc, vc = clip(u, 0.0, W - 1.0), clip(v, 0.0, H - 1.0)
    xs = torch.arange(W, dtype=torch.float32, device=src.device)
    wx = p.q(torch.relu(1.0 - (xs - uc[..., None]).abs()))
    mid = p.q(torch.einsum("byxw,bywc->byxc", wx, src))
    hs = torch.arange(H, dtype=torch.float32, device=src.device)
    wy = p.q(torch.relu(1.0 - (hs - vc[..., None]).abs()))
    out = p.q(torch.einsum("byxh,bhxc->byxc", wy, mid))
    return p.q(out * valid)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, fill: str, band: tuple[int, int] | None):
    """Bilinear samples of `img` (B, H, W, C) at pixel coordinates
    `coords` (B, H, W, 2) = (u, v), edge-clamped; with `band` = (rv, rh)
    each displacement from the pixel is first clamped to +-rv rows and
    +-rh columns (the banded warp). fill="zeros" zeroes samples whose
    unclamped point lies out of frame. Returns (samples, valid)."""
    B, H, W, C = img.shape
    u, v = coords[..., 0], coords[..., 1]
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0))[..., None].float()
    if band is not None:
        rv, rh = band
        xg = torch.arange(W, dtype=torch.float32, device=img.device)
        yg = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
        u = (u - xg).clamp(-rh, rh) + xg
        v = (v - yg).clamp(-rv, rv) + yg
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    u0c, v0c = u0.clamp(0, W - 1).long(), v0.clamp(0, H - 1).long()
    u1c, v1c = (u0 + 1).clamp(0, W - 1).long(), (v0 + 1).clamp(0, H - 1).long()
    flat = img.reshape(B, H * W, C)

    def tap(vi, ui):
        idx = (vi * W + ui).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(vi.shape + (C,))

    top = tap(v0c, u0c) * (1.0 - du) + tap(v0c, u1c) * du
    bot = tap(v1c, u0c) * (1.0 - du) + tap(v1c, u1c) * du
    out = top * (1.0 - dv) + bot * dv
    return (out if fill == "border" else out * valid), valid


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2 over 3x3 VALID average pools, clipped to [0, 1]."""

    def pool(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 3, stride=1).permute(0, 2, 3, 1)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x * mu_x
    sigma_y = pool(y * y) - mu_y * mu_y
    sigma_xy = pool(x * y) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + 0.01**2) * (2.0 * sigma_xy + 0.03**2)
    den = (mu_x * mu_x + mu_y * mu_y + 0.01**2) * (sigma_x + sigma_y + 0.03**2)
    return clip((1.0 - num / den) * 0.5, 0.0, 1.0)
