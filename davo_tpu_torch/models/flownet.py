"""FlowNetLite: PWC-style coarse-to-fine optical flow (port of
davo_tpu.models.flownet).

Every `costvol_impl` of the reference computes the same function, so
here the cost volume always goes through `kernels.costvol.cost_volume`:
the hand-written CUDA kernel on the GPU, its plain version on the CPU.
The fused flags route as in the reference: `fuse_pyramid` runs the
whole (s2, s1) ladder as one `conv_chain_strided` with taps (when every
stride-2 layer sees even dims), `fuse_flow_level` (with no estimator
bottleneck) a whole level as one `flow_level_fused`, superseding
`fuse_estimator`, which runs the estimator chain as one
`conv_chain_nhwc` after the optional `est_in`. Each `_train` flag runs
the same function through its differentiable variant
(`kernels/rowconv_ad.py`) and wins over its serving flag; the flow
level's and the estimator's take `compute_dtype`, the pyramid's
`fuse_compute or compute_dtype`, as in the reference. The fused layers
round as the kernels do (`kernels/rowconv.py`), not as `ConvBlock`.
`s2d_first_conv` evaluates the unfused pyramid's first layer through
space-to-depth.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from davo_tpu_torch.config import ModelConfig
from davo_tpu_torch.core.warp import flow_warp_separable
from davo_tpu_torch.kernels.costvol import cost_volume
from davo_tpu_torch.kernels.resize import resize_bilinear_aligned
from davo_tpu_torch.kernels.rowconv import (
    conv_chain_nhwc,
    conv_chain_strided,
    flow_level_fused,
    fusable_even_prefix,
)
from davo_tpu_torch.kernels.rowconv_ad import (
    conv_chain_nhwc_ad,
    conv_chain_strided_ad,
    flow_level_fused_ad,
)
from davo_tpu_torch.models.common import Conv, ConvBlock, dtype_of

_LEVEL_CHANNELS = (16, 32, 64, 96)
_EST_RELUS = (True, True, True, False)


def _conv_params(block: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) of a `ConvBlock` or a bare `Conv`."""
    conv = getattr(block, "Conv_0", block)
    return conv.weight, conv.bias


class FeaturePyramid(nn.Module):
    """(B, H, W, 3) -> [(B, H/2, W/2, 16), (B, H/4, W/4, 32), ...]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = dtype_of(cfg.compute_dtype)
        cin = 3
        self.levels = len(_LEVEL_CHANNELS[: cfg.flow_levels])
        for i, ch in enumerate(_LEVEL_CHANNELS[: cfg.flow_levels]):
            s2d = i == 0 and cfg.s2d_first_conv
            self.add_module(f"feat{i}a", ConvBlock(cin, ch, 3, 2, dt, s2d))
            self.add_module(f"feat{i}b", ConvBlock(ch, ch, 3, 1, dt))
            cin = ch
        self.dtype = dt
        self.fuse = cfg.fuse_pyramid or cfg.fuse_pyramid_train
        self.chain = conv_chain_strided_ad if cfg.fuse_pyramid_train else conv_chain_strided
        self.mode = cfg.fuse_compute or cfg.compute_dtype

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        x = img.to(self.dtype)
        strides = (2, 1) * self.levels
        if self.fuse and fusable_even_prefix(x.shape[1], x.shape[2], strides) == len(strides):
            ws, bs = zip(*(
                _conv_params(getattr(self, f"feat{i}{suf}"))
                for i in range(self.levels) for suf in "ab"
            ))
            pyr = self.chain(
                x.contiguous(), ws, bs, strides, (True,) * len(strides),
                taps=tuple(2 * i + 1 for i in range(self.levels)), compute_dtype_name=self.mode,
            )
            return [f.to(self.dtype) for f in pyr]
        pyr = []
        for i in range(self.levels):
            x = getattr(self, f"feat{i}b")(getattr(self, f"feat{i}a")(x))
            pyr.append(x)
        return pyr  # fine (/2) -> coarse


class FlowEstimator(nn.Module):
    """[cost volume, features, upsampled flow] -> refined flow (f32)."""

    def __init__(self, cfg: ModelConfig, cin: int):
        super().__init__()
        dt = dtype_of(cfg.compute_dtype)
        self.dtype = dt
        self.fuse = cfg.fuse_estimator or cfg.fuse_estimator_train
        if cfg.fuse_estimator_train:
            self.chain, self.mode = conv_chain_nhwc_ad, cfg.compute_dtype
        else:
            self.chain, self.mode = conv_chain_nhwc, cfg.fuse_compute or cfg.compute_dtype
        if cfg.flow_est_bottleneck > 0:
            self.est_in = ConvBlock(cin, cfg.flow_est_bottleneck, 1, 1, dt)
            cin = cfg.flow_est_bottleneck
        for i, ch in enumerate((96, 64, 32)):
            self.add_module(f"est{i}", ConvBlock(cin, ch, 3, 1, dt))
            cin = ch
        self.flow = Conv(cin, 2, 3, 1, dt)

    def forward(self, cv, feat, flow_up):
        x = torch.cat([cv.to(self.dtype), feat, flow_up.to(self.dtype)], -1)
        if hasattr(self, "est_in"):
            x = self.est_in(x)
        if self.fuse:
            ws, bs = self.chain_params()
            return flow_up + self.chain(x.contiguous(), ws, bs, _EST_RELUS, self.mode)
        x = self.est2(self.est1(self.est0(x)))
        return flow_up + self.flow(x).float()

    def chain_params(self):
        """Weights and biases of est0, est1, est2 and the flow head."""
        return zip(*(_conv_params(m) for m in (self.est0, self.est1, self.est2, self.flow)))


class FlowNetLite(nn.Module):
    """(img1, img2) -> flow pyramid fine->coarse [(B, H/4, W/4, 2), ...],
    in pixels at each level's own resolution (f32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.search = cfg.flow_search_range
        self.levels = cfg.flow_levels
        # As the reference: the fused level needs the plain estimator input.
        self.fuse_level = (cfg.fuse_flow_level or cfg.fuse_flow_level_train) and cfg.flow_est_bottleneck == 0
        if cfg.fuse_flow_level_train:
            self.level, self.mode = flow_level_fused_ad, cfg.compute_dtype
        else:
            self.level, self.mode = flow_level_fused, cfg.fuse_compute or cfg.compute_dtype
        dt = dtype_of(cfg.compute_dtype)
        self.pyramid = FeaturePyramid(cfg)
        d2 = (2 * self.search + 1) ** 2
        for lv in range(1, cfg.flow_levels):
            self.add_module(
                f"estimator{lv}", FlowEstimator(cfg, d2 + _LEVEL_CHANNELS[lv] + 2)
            )
        self.project = cfg.costvol_feat_channels > 0
        if self.project:
            # One linear 1x1 shared by both maps: the correlation stays
            # a dot product in a learned subspace.
            for lv in range(1, cfg.flow_levels):
                self.add_module(
                    f"cv_proj{lv}",
                    Conv(_LEVEL_CHANNELS[lv], cfg.costvol_feat_channels, 1, 1, dt),
                )

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> list[torch.Tensor]:
        B = img1.shape[0]
        pboth = self.pyramid(torch.cat([img1, img2], 0))
        flows: list[torch.Tensor] = []
        flow = None
        # Coarse -> fine, skipping the /2 level (stop at index 1 == /4).
        for level in range(len(pboth) - 1, 0, -1):
            f1, f2 = pboth[level][:B], pboth[level][B:]
            _, H, W, _ = f1.shape
            if flow is None:
                flow_up = torch.zeros((B, H, W, 2), dtype=torch.float32, device=f1.device)
                f2w = f2
            else:
                flow_up = 2.0 * resize_bilinear_aligned(flow, H, W)
                f2w, _ = flow_warp_separable(f2, flow_up)
            f1c, f2c = f1, f2w
            if self.project:
                proj = getattr(self, f"cv_proj{level}")
                f1c, f2c = proj(f1), proj(f2w)
            estimator = getattr(self, f"estimator{level}")
            if self.fuse_level:
                ws, bs = estimator.chain_params()
                delta = self.level(
                    f1c.contiguous(), f2c.contiguous(), f1.contiguous(), flow_up.contiguous(), ws, bs,
                    self.search, _EST_RELUS, self.mode,
                )
                flow = flow_up + delta
            else:
                # The kernel reads the maps in their own dtype (float32
                # or bf16) and widens them; only differing dtypes meet
                # in float32.
                if f1c.dtype != f2c.dtype:
                    f1c, f2c = f1c.float(), f2c.float()
                cv = torch.relu(cost_volume(f1c.contiguous(), f2c.contiguous(), self.search))
                flow = estimator(cv, f1, flow_up)
            flows.append(flow)
        return flows[::-1]  # fine (/4) first

    @staticmethod
    def full_res_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """Upsample a /k-level flow to full resolution; du and dv scale
        independently (width/w, height/h)."""
        _, h, w, _ = flow.shape
        scale = torch.tensor([width / w, height / h], dtype=flow.dtype, device=flow.device)
        return resize_bilinear_aligned(flow, height, width) * scale
