"""Shared building blocks: Flax-equivalent conv layers on NHWC tensors.

Parameters are float32 and named as in the Flax tree (`Conv_0`,
`weight` for Flax's `kernel`), so `convert.py` maps a checkpoint by
path alone. Init mirrors Flax's defaults: lecun-normal kernels
(truncated normal, fan-in) and zero biases, from a seeded generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA `padding="SAME"`: output ceil(size/stride), the total
    padding split with the smaller half low. Stride 2 on an even input
    pads (0, 1) for a 3x3 and (2, 3) for a 7x7 — torch's symmetric
    `padding=k//2` would shift every such feature map."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same_stride2_s2d(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """A stride-2 SAME conv (OIHW `weight`) on NHWC `x` with even H, W,
    evaluated through space-to-depth: the same products, 4x the
    contraction depth (the reference's `conv_same_stride2_s2d`).

    Pad the input with SAME's k - 2 total (low half first) and up to the
    even K2 = 2 * ceil(k / 2) grid, fold each 2x2 phase block into
    channels (C -> 4C, H, W -> H/2, W/2), zero-pad the kernel to K2 and
    fold its taps dy = 2a + py the same way; then a VALID stride-1
    (K2/2 x K2/2) conv gives out[y, x] = sum S[y+a, x+b, (py, px, c)] *
    w[2a+py, 2b+px, c]. The output is rounded to `dtype`, then the bias
    added in it, as `Conv`."""
    O, C, k, _ = weight.shape
    B, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"space-to-depth needs even H, W, not {(H, W)}")
    K2 = 2 * ((k + 1) // 2)
    pad_lo = (k - 2) // 2
    pad_hi = (k - 2) - pad_lo + (K2 - k)
    xp = F.pad(x, (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
    Hp, Wp = H + K2 - 2, W + K2 - 2
    s = xp.reshape(B, Hp // 2, 2, Wp // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    s = s.reshape(B, Hp // 2, Wp // 2, 4 * C)
    w8 = F.pad(weight, (0, K2 - k, 0, K2 - k))  # (O, C, K2, K2)
    wn = w8.reshape(O, C, K2 // 2, 2, K2 // 2, 2).permute(0, 3, 5, 1, 2, 4)
    wn = wn.reshape(O, 4 * C, K2 // 2, K2 // 2)  # in-channels ordered (py, px, c)
    y = F.conv2d(s.to(dtype).permute(0, 3, 1, 2), wn.to(dtype))
    return y.permute(0, 2, 3, 1) + bias.to(dtype)


class Conv(nn.Module):
    """`flax.linen.Conv(features, (k, k), strides, padding="SAME",
    dtype=dtype, param_dtype=float32)` on NHWC input: input, kernel and
    bias are cast to `dtype` and the conv runs in it. `s2d=True` (the
    reference's `ConvBlock(s2d=True)`) evaluates a stride-2 conv on an
    even-sized input through `conv_same_stride2_s2d`, with the same
    parameters."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, s2d: bool = False):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.s2d = s2d and stride == 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel, self.stride
        if self.s2d and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            return conv_same_stride2_s2d(x, self.weight, self.bias, self.dtype)
        (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[1:3])
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom))
            pad = 0
        # An NHWC tensor seen as NCHW is channels-last memory: no copy.
        y = F.conv2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.weight.to(self.dtype),
            stride=s,
            padding=pad,
        )
        # Bias after the conv's output is rounded to `dtype`, as Flax adds it.
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


class ConvBlock(nn.Module):
    """Conv + ReLU in the compute dtype (the reference's ConvBlock)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, s2d: bool = False):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, dtype, s2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Conv_0(x))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NHWC."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest 2x upsample, then crop to (h, w): each DispNet decoder
    target is ceil(2x/2) of its source, which 2x-then-crop reaches."""
    h, w = hw
    if h > 2 * x.shape[1] or w > 2 * x.shape[2]:
        raise ValueError(f"resize_nearest {tuple(x.shape[1:3])} -> {hw} is more than 2x")
    return upsample2(x)[:, :h, :w]


def lecun_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default init for every Conv and Linear under `module`, in
    module order: truncated-normal kernels (bounds +-2 sigma, variance
    1/fan_in after truncation) and zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                nn.init.zeros_(m.bias)
    return module
