"""Dynamic region attention (port of davo_tpu.models.attention).

Flow drives a small net that produces one weight per semantic region
(softmax x K, so uniform weights are the identity); the segmentation
turns them into a spatial map at the pose features' resolution. With
`fuse_attention` the even-dim prefix of the stride-2 conv stack runs as
one `conv_chain_strided` and the tail as `ConvBlock`s, as in the
reference; with `fuse_attention_train` the prefix runs as the
differentiable `conv_chain_strided_ad`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from davo_tpu_torch.config import ModelConfig
from davo_tpu_torch.kernels.resize import resize_bilinear
from davo_tpu_torch.kernels.rowconv import conv_chain_strided, even_prefix_chain
from davo_tpu_torch.kernels.rowconv_ad import conv_chain_strided_ad
from davo_tpu_torch.models.common import ConvBlock, dtype_of


class RegionAttention(nn.Module):
    """Flow cue stack (B, H, W, F) -> per-region weights (B, K), f32."""

    def __init__(self, cfg: ModelConfig, cin: int):
        super().__init__()
        self.dtype = dtype_of(cfg.compute_dtype)
        self.num_classes = cfg.num_seg_classes
        self.fuse = cfg.fuse_attention or cfg.fuse_attention_train
        self.chain = conv_chain_strided_ad if cfg.fuse_attention_train else conv_chain_strided
        self.mode = cfg.fuse_compute or cfg.compute_dtype
        for i, ch in enumerate((16, 32, 64)):
            self.add_module(f"conv{i}", ConvBlock(cin, ch, 3, 2, self.dtype))
            cin = ch
        self.fc0 = nn.Linear(64, 64)
        self.fc1 = nn.Linear(64, cfg.num_seg_classes)

    def forward(self, flow: torch.Tensor) -> torch.Tensor:
        x = flow.to(self.dtype)
        start = 0
        if self.fuse:
            convs = [getattr(self, f"conv{i}").Conv_0 for i in range(3)]
            x, start = even_prefix_chain(x, convs, self.mode, self.chain)
            x = x.to(self.dtype)
        for i in range(start, 3):
            x = getattr(self, f"conv{i}")(x)
        # Mean in the compute dtype (accumulated in f32), then f32.
        x = x.mean(dim=(1, 2)).float()
        logits = self.fc1(torch.relu(self.fc0(x)))
        return torch.softmax(logits, -1) * self.num_classes


def seg_to_onehot(seg: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int labels -> (B, H, W, K) float32 one-hot (labels
    outside [0, K) give an all-zero row, as `jax.nn.one_hot`)."""
    classes = torch.arange(num_classes, device=seg.device)
    return (seg[..., None] == classes).float()


def region_weight_map(
    weights: torch.Tensor, seg: torch.Tensor, num_classes: int, hw: tuple[int, int]
) -> torch.Tensor:
    """Per-region weights (B, K) + labels (B, H, W) -> (B, h, w, 1).

    Where (h, w) divides (H, W), the reference average-pools the one-hot
    into per-cell class fractions. This counts the labels of each cell
    directly instead, so the (B, H, W, K) one-hot is never built (1 GB at
    B=256, 128x416). The counts are integers below 2^24, exact in f32.
    They are scattered into a buffer of known size, so nothing reads a
    value back to the host (as `bincount` does on the GPU). Otherwise the
    map is formed at full resolution (each pixel its label's weight,
    which is what the one-hot contraction gives) and resized as the
    reference resizes it (antialiased when it shrinks).
    """
    B, H, W = seg.shape
    h, w = hw
    K = num_classes
    if (H, W) == (h, w):
        return torch.einsum("bhwk,bk->bhw", seg_to_onehot(seg, K), weights)[..., None]
    if H % h or W % w:
        valid = (seg >= 0) & (seg < K)
        label = torch.where(valid, seg.long(), 0).reshape(B, H * W)
        wmap = torch.where(valid, weights.gather(1, label).reshape(B, H, W), 0.0)
        return resize_bilinear(wmap[..., None], h, w)
    rows = torch.arange(H, device=seg.device) // (H // h)
    cols = torch.arange(W, device=seg.device) // (W // w)
    cell = (rows[:, None] * w + cols[None, :])[None]  # (1, H, W)
    batch = torch.arange(B, device=seg.device)[:, None, None] * (h * w)
    # Labels outside [0, K) have an all-zero one-hot row: count them in
    # an extra bin K that is dropped.
    label = torch.where((seg >= 0) & (seg < K), seg.long(), K)
    index = ((batch + cell) * (K + 1) + label).flatten()
    counts = torch.zeros(B * h * w * (K + 1), dtype=torch.float32, device=seg.device)
    ones = torch.ones((), dtype=torch.float32, device=seg.device).expand(index.numel())
    counts.scatter_add_(0, index, ones)
    counts = counts.reshape(B, h, w, K + 1)[..., :K]
    pooled = counts / float((H // h) * (W // w))
    return torch.einsum("bhwk,bk->bhw", pooled, weights)[..., None]
