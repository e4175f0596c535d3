"""PoseNet: frame-pair 6-DoF egomotion regression (port of
davo_tpu.models.posenet).

Stride-2 conv stack on the concatenated pair, optional region-attention
map multiplied into the features, 1x1 conv head, global mean, x
pose_scale. Output ``[tx, ty, tz, rx, ry, rz] * pose_scale`` maps
target-cam points to source-cam points. With `fuse_pose_encoder` the
even-dim prefix of the stride-2 stack runs as one `conv_chain_strided`
and the tail as `ConvBlock`s, as in the reference; with
`fuse_pose_encoder_train` the prefix runs as the differentiable
`conv_chain_strided_ad`. `s2d_first_conv` evaluates the first layer
through space-to-depth where it is not inside the fused prefix.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from davo_tpu_torch.config import ModelConfig
from davo_tpu_torch.kernels.rowconv import conv_chain_strided, even_prefix_chain
from davo_tpu_torch.kernels.rowconv_ad import conv_chain_strided_ad
from davo_tpu_torch.models.common import Conv, ConvBlock, dtype_of


class PoseEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, cin: int):
        super().__init__()
        self.dtype = dtype_of(cfg.compute_dtype)
        self.depth = len(cfg.pose_channels)
        self.fuse = cfg.fuse_pose_encoder or cfg.fuse_pose_encoder_train
        self.chain = conv_chain_strided_ad if cfg.fuse_pose_encoder_train else conv_chain_strided
        self.mode = cfg.fuse_compute or cfg.compute_dtype
        for i, ch in enumerate(cfg.pose_channels):
            k = 7 if i == 0 else (5 if i == 1 else 3)
            s2d = i == 0 and cfg.s2d_first_conv
            self.add_module(f"enc{i}", ConvBlock(cin, ch, k, 2, self.dtype, s2d))
            cin = ch

    def forward(self, pair: torch.Tensor) -> torch.Tensor:
        x = pair.to(self.dtype)
        start = 0
        if self.fuse:
            convs = [getattr(self, f"enc{i}").Conv_0 for i in range(self.depth)]
            x, start = even_prefix_chain(x, convs, self.mode, self.chain)
            x = x.to(self.dtype)
        for i in range(start, self.depth):
            x = getattr(self, f"enc{i}")(x)
        return x


class PoseHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.pose_scale = cfg.pose_scale
        self.pose_head = Conv(cfg.pose_channels[-1], 6, 1, 1, dtype_of(cfg.compute_dtype))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        pose = self.pose_head(features).float().mean(dim=(1, 2))
        return pose * self.pose_scale


class PoseNet(nn.Module):
    """(target, source, extra cue channels) -> (B, 6) pose vectors."""

    def __init__(self, cfg: ModelConfig, extra_channels: int = 0):
        super().__init__()
        self.encoder = PoseEncoder(cfg, 6 + extra_channels)
        self.head = PoseHead(cfg)

    def forward(self, target, source, extra=None, region_weight_fn=None):
        """`region_weight_fn`, if given, maps the encoder's (h, w) to a
        (B, h, w, 1) attention map multiplied into the features."""
        parts = [target, source] + ([extra] if extra is not None else [])
        features = self.encoder(torch.cat(parts, -1))
        if region_weight_fn is not None:
            wmap = region_weight_fn((features.shape[1], features.shape[2]))
            features = features * wmap.to(features.dtype)
        return self.head(features)
