"""DispNet: encoder-decoder monocular disparity network (port of
davo_tpu.models.dispnet, conv encoder).

Stride-2 conv pairs down (7x7, 5x5, then 3x3 first kernels), a
nearest-upsample + conv decoder with skips, and sigmoid disparity heads
on the last `num_scales` levels, in f32. depth = min_depth *
(max_depth / min_depth) ** disp. With `fuse_disp_encoder` the encoder's
longest prefix of (s2, s1) pairs whose stride-2 layers see even dims
runs as one `conv_chain_strided`, each pair's output a tap (the skips);
`fuse_disp_encoder_train` runs it as the differentiable
`conv_chain_strided_ad`; the rest stays `ConvBlock`s, as in the
reference. `disp_encoder="resnet"` (the reference's `disp_net_res`
variant) swaps the encoder for a 7x7 stem and residual basic blocks of
the same widths and levels, so the decoder is shared; it is never fused
(both fuse flags are ignored with it, as in the reference).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from davo_tpu_torch.config import ModelConfig
from davo_tpu_torch.kernels.rowconv import conv_chain_strided, fusable_even_prefix
from davo_tpu_torch.kernels.rowconv_ad import conv_chain_strided_ad
from davo_tpu_torch.models.common import Conv, ConvBlock, dtype_of, resize_nearest

MIN_DEPTH = 0.5
MAX_DEPTH = 100.0


def disp_to_depth(
    disp: torch.Tensor, min_depth: float = MIN_DEPTH, max_depth: float = MAX_DEPTH
) -> torch.Tensor:
    """Sigmoid disparity in (0, 1) -> depth, log-space parametrization."""
    return min_depth * torch.pow(max_depth / min_depth, disp)


def depth_to_disp(
    depth: torch.Tensor, min_depth: float = MIN_DEPTH, max_depth: float = MAX_DEPTH
) -> torch.Tensor:
    """Inverse of `disp_to_depth`."""
    return torch.log(depth / min_depth) / math.log(max_depth / min_depth)


class ResBlock(nn.Module):
    """Pre-ReLU residual basic block: two 3x3 convs, a 1x1 projection
    shortcut on a stride or width change, no norm layers; the residual
    sum in the compute dtype (the reference's `ResBlock`)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, dtype)
        self.conv2 = Conv(cout, cout, 3, 1, dtype)
        if stride != 1 or cin != cout:
            self.proj = Conv(cin, cout, 1, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(torch.relu(self.conv1(x)))
        if hasattr(self, "proj"):
            x = self.proj(x)
        return torch.relu(x + h)


class DispNet(nn.Module):
    """(B, H, W, 3) -> `num_scales` disparity maps (B, H/2^s, W/2^s, 1)
    in f32, full resolution first."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.disp_encoder not in ("conv", "resnet"):
            raise ValueError(f"unknown disp_encoder {cfg.disp_encoder!r}")
        dt = dtype_of(cfg.compute_dtype)
        self.dtype = dt
        resnet = cfg.disp_encoder == "resnet"
        self.fuse = (cfg.fuse_disp_encoder or cfg.fuse_disp_encoder_train) and not resnet
        self.chain = conv_chain_strided_ad if cfg.fuse_disp_encoder_train else conv_chain_strided
        self.mode = cfg.fuse_compute or cfg.compute_dtype
        self.num_scales = cfg.num_scales
        chans = tuple(cfg.disp_channels)
        self.depth = len(chans)
        cin = 3
        for i, ch in enumerate(chans):
            if resnet:  # the stem keeps the 7x7's receptive field
                first = ConvBlock(cin, ch, 7, 2, dt) if i == 0 else ResBlock(cin, ch, 2, dt)
                self.add_module(f"enc{i}", first)
                self.add_module(f"enc{i}b", ResBlock(ch, ch, 1, dt))
            else:
                k = 7 if i == 0 else (5 if i == 1 else 3)
                self.add_module(f"enc{i}", ConvBlock(cin, ch, k, 2, dt))
                self.add_module(f"enc{i}b", ConvBlock(ch, ch, 3, 1, dt))
            cin = ch
        self.up_channels = list(chans[::-1][1:]) + [16]
        for i, ch in enumerate(self.up_channels):
            skip_idx = self.depth - 2 - i
            self.add_module(f"dec{i}", ConvBlock(cin, ch, 3, 1, dt))
            skip_ch = chans[skip_idx] if skip_idx >= 0 else 0
            self.add_module(f"dec{i}b", ConvBlock(ch + skip_ch, ch, 3, 1, dt))
            level = len(self.up_channels) - 1 - i  # 0 = full res
            if level < self.num_scales:
                self.add_module(f"disp{level}", Conv(ch, 1, 3, 1, dt))
            cin = ch

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        x = img.to(self.dtype)
        skips = []
        start = 0
        if self.fuse:
            strides = (2, 1) * self.depth
            start = fusable_even_prefix(x.shape[1], x.shape[2], strides) // 2
            if start:
                convs = [getattr(self, f"enc{i}{s}").Conv_0 for i in range(start) for s in ("", "b")]
                outs = self.chain(
                    x.contiguous(), [c.weight for c in convs], [c.bias for c in convs],
                    strides[: 2 * start], (True,) * (2 * start),
                    taps=tuple(2 * i + 1 for i in range(start)), compute_dtype_name=self.mode,
                )
                skips = [o.to(self.dtype) for o in outs]
                x = skips[-1]
        for i in range(start, self.depth):
            x = getattr(self, f"enc{i}b")(getattr(self, f"enc{i}")(x))
            skips.append(x)
        disps = []
        full_hw = (img.shape[1], img.shape[2])
        for i in range(len(self.up_channels)):
            skip_idx = self.depth - 2 - i
            target_hw = tuple(skips[skip_idx].shape[1:3]) if skip_idx >= 0 else full_hw
            x = getattr(self, f"dec{i}")(resize_nearest(x, target_hw))
            if skip_idx >= 0:
                x = torch.cat([x, skips[skip_idx]], -1)
            x = getattr(self, f"dec{i}b")(x)
            level = len(self.up_channels) - 1 - i
            if level < self.num_scales:
                disps.append(torch.sigmoid(getattr(self, f"disp{level}")(x).float()))
        return disps[::-1]  # built coarse -> fine; scale 0 first
