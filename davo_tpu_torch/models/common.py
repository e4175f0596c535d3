"""Shared building blocks: Flax-equivalent conv layers on NHWC tensors.

Parameters are float32 and named as in the Flax tree (`Conv_0`,
`weight` for Flax's `kernel`), so `convert.py` maps a checkpoint by
path alone. Init mirrors Flax's defaults: lecun-normal kernels
(truncated normal, fan-in) and zero biases, from a seeded generator.

`Conv` and `Dense` also run tensor-parallel: with DTensor parameters
(`dist.sharding_rules.shard_params_tp`) each computes its own output
channels (`sharding_rules.column_parallel`); `Conv.whole_params` gives
the whole weight and bias to the callers that hand them to a fused
kernel.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn as nn
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor, without importing torch.distributed.tensor
    (about a second) where nothing has made one."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


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


def conv_same_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """A SAME convolution of NHWC `x` with OIHW `weight` on `F.conv2d`, in
    the operands' dtype: the output rounded to it, then the bias added in
    it, as Flax adds it. Symmetric pads go to the conv, others pad first."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (same_pads(n, k, stride) for n in x.shape[1:3])
    if (top, left) == (bottom, right):
        pad = (top, left)
    else:
        x = F.pad(x, (0, 0, left, right, top, bottom))
        pad = 0
    # An NHWC tensor seen as NCHW is channels-last memory: no copy.
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + bias


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
    bias are cast to `dtype` and the conv runs in it (float32 on the
    card: the port's split-TF32 kernels, `kernels/conv_f32.py`). `s2d=True`
    (the reference's `ConvBlock(s2d=True)`) evaluates a stride-2 bf16 conv
    on an even-sized input through `conv_same_stride2_s2d`, with the same
    parameters."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, s2d: bool = False):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.s2d = s2d and stride == 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(self.weight):
            from davo_tpu_torch.dist.sharding_rules import column_parallel

            return column_parallel(self._conv, x, self.weight, self.bias)
        return self._conv(x, self.weight, self.bias)

    def whole_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) whole: a fused kernel reads every output channel,
        so tensor-parallel parameters are all-gathered first (differentiably;
        `sharding_rules.whole`), as GSPMD gathers a sharded operand at a
        custom call."""
        if is_dtensor(self.weight):
            from davo_tpu_torch.dist.sharding_rules import whole

            return whole(self.weight), whole(self.bias)
        return self.weight, self.bias

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The conv on plain tensors (a tensor-parallel layer's local
        shard too). float32 runs `kernels.conv_f32.conv_same`: on the card
        the port's split-TF32 kernels (an s2d layer on its SAME stride-2
        form, the same products), on the CPU this module's plain
        computation; bf16 runs `_torch_conv`."""
        if self.dtype == torch.float32:
            from davo_tpu_torch.kernels import conv_f32

            return conv_f32.conv_same(x.float(), weight, bias, self.stride)
        return self._torch_conv(x, weight, bias)

    def _torch_conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The conv on PyTorch's own convolution (cuDNN on the card),
        space-to-depth where `s2d` is set and the dims are even."""
        if self.s2d and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            return conv_same_stride2_s2d(x, weight, bias, self.dtype)
        return conv_same_torch(x.to(self.dtype), weight.to(self.dtype), bias.to(self.dtype), self.stride)


class Dense(nn.Linear):
    """`flax.linen.Dense` in float32 (`nn.Linear`), tensor-parallel with
    DTensor parameters as `Conv`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(self.weight):
            from davo_tpu_torch.dist.sharding_rules import column_parallel

            return column_parallel(F.linear, x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)


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
