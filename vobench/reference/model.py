"""The DAVO network in plain PyTorch (Kuo et al., "Dynamic Attention-based
Visual Odometry", 2020; the benchmarked program's conv encoder variant):

    (I_tgt, I_src) -> FlowNetLite (PWC-style pyramid, cost volume, flow
    estimators) -> finest flow -> RegionAttention (one weight per
    semantic class) -> PoseNet (stride-2 encoder, region-weighted
    features, 1x1 head, global mean) -> 6-DoF pose;
    DispNet (encoder-decoder with skips, sigmoid disparities) in training.

Parameters are float32 and named as the benchmarked program names its
own (`<module>.Conv_0.weight`, OIHW), so one state dict made by the
benchmark loads into both. The configuration is the dict under "model"
in a benchmark configuration file; `Precision` says where compute
rounds. Only the options the benchmark's configurations use are built:
attention "flow_seg" with the flow cue, the conv pose head, the conv
DispNet encoder.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vobench.reference import ops
from vobench.reference.ops import Precision

LEVEL_CHANNELS = (16, 32, 64, 96)
EST_CHANNELS = (96, 64, 32)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int, p: Precision):
        super().__init__()
        self.stride, self.p = stride, p
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return ops.conv_same(x, self.weight, self.bias, self.stride, self.p)


class ConvBlock(nn.Module):
    """Conv and ReLU."""

    def __init__(self, cin, cout, kernel, stride, p):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, p)

    def forward(self, x):
        return torch.relu(self.Conv_0(x))


class FeaturePyramid(nn.Module):
    def __init__(self, cfg: dict, p: Precision):
        super().__init__()
        self.p, self.levels = p, cfg["flow_levels"]
        cin = 3
        for i, ch in enumerate(LEVEL_CHANNELS[: self.levels]):
            self.add_module(f"feat{i}a", ConvBlock(cin, ch, 3, 2, p))
            self.add_module(f"feat{i}b", ConvBlock(ch, ch, 3, 1, p))
            cin = ch

    def forward(self, img):
        x, out = self.p.q(img), []
        for i in range(self.levels):
            x = getattr(self, f"feat{i}b")(getattr(self, f"feat{i}a")(x))
            out.append(x)
        return out


class FlowEstimator(nn.Module):
    def __init__(self, cfg: dict, cin: int, p: Precision):
        super().__init__()
        self.p = p
        if cfg["flow_est_bottleneck"] > 0:
            self.est_in = ConvBlock(cin, cfg["flow_est_bottleneck"], 1, 1, p)
            cin = cfg["flow_est_bottleneck"]
        for i, ch in enumerate(EST_CHANNELS):
            self.add_module(f"est{i}", ConvBlock(cin, ch, 3, 1, p))
            cin = ch
        self.flow = Conv(cin, 2, 3, 1, p)

    def forward(self, cv, feat, flow_up):
        x = torch.cat([self.p.q(cv), feat, self.p.q(flow_up)], -1)
        if hasattr(self, "est_in"):
            x = self.est_in(x)
        return flow_up + self.flow(self.est2(self.est1(self.est0(x))))


class FlowNetLite(nn.Module):
    """(img1, img2) -> flows fine (/4) to coarse, in each level's pixels."""

    def __init__(self, cfg: dict, p: Precision):
        super().__init__()
        self.p, self.search, self.levels = p, cfg["flow_search_range"], cfg["flow_levels"]
        self.pyramid = FeaturePyramid(cfg, p)
        d2 = (2 * self.search + 1) ** 2
        for lv in range(1, self.levels):
            self.add_module(f"estimator{lv}", FlowEstimator(cfg, d2 + LEVEL_CHANNELS[lv] + 2, p))
        self.project = cfg["costvol_feat_channels"] > 0
        if self.project:
            for lv in range(1, self.levels):
                self.add_module(f"cv_proj{lv}", Conv(LEVEL_CHANNELS[lv], cfg["costvol_feat_channels"], 1, 1, p))

    def forward(self, img1, img2):
        B = img1.shape[0]
        pboth = self.pyramid(torch.cat([img1, img2], 0))
        flows, flow = [], None
        for level in range(len(pboth) - 1, 0, -1):
            f1, f2 = pboth[level][:B], pboth[level][B:]
            _, H, W, _ = f1.shape
            if flow is None:
                flow_up = torch.zeros((B, H, W, 2), dtype=torch.float32, device=f1.device)
                f2w = f2
            else:
                flow_up = 2.0 * ops.resize_aligned(flow, H, W)
                f2w = ops.flow_warp_separable(f2, flow_up, self.p)
            f1c, f2c = f1, f2w
            if self.project:
                proj = getattr(self, f"cv_proj{level}")
                f1c, f2c = proj(f1), proj(f2w)
            cv = torch.relu(ops.cost_volume(f1c, f2c, self.search))
            flow = getattr(self, f"estimator{level}")(cv, f1, flow_up)
            flows.append(flow)
        return flows[::-1]


def full_res_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    _, h, w, _ = flow.shape
    scale = torch.tensor([width / w, height / h], dtype=flow.dtype, device=flow.device)
    return ops.resize_aligned(flow, height, width) * scale


class RegionAttention(nn.Module):
    """Flow (B, H, W, 2) -> per-class weights (B, K): softmax times K."""

    def __init__(self, cfg: dict, cin: int, p: Precision):
        super().__init__()
        self.p, self.num_classes = p, cfg["num_seg_classes"]
        for i, ch in enumerate((16, 32, 64)):
            self.add_module(f"conv{i}", ConvBlock(cin, ch, 3, 2, p))
            cin = ch
        self.fc0 = nn.Linear(64, 64)
        self.fc1 = nn.Linear(64, self.num_classes)

    def forward(self, flow):
        x = self.conv2(self.conv1(self.conv0(self.p.q(flow))))
        x = self.p.q(x.mean(dim=(1, 2)))
        return torch.softmax(self.fc1(torch.relu(self.fc0(x))), -1) * self.num_classes


def region_weight_map(weights: torch.Tensor, seg: torch.Tensor, num_classes: int, hw) -> torch.Tensor:
    """Class weights (B, K) and labels (B, H, W) -> (B, h, w, 1): each
    cell's class fractions (an average-pooled one-hot) times the weights
    where (h, w) divides (H, W); otherwise each pixel's weight, resized."""
    B, H, W = seg.shape
    h, w = hw
    onehot = (seg[..., None] == torch.arange(num_classes, device=seg.device)).float()
    if H % h == 0 and W % w == 0:
        pooled = onehot.reshape(B, h, H // h, w, W // w, num_classes).mean(dim=(2, 4))
        return torch.einsum("bhwk,bk->bhw", pooled, weights)[..., None]
    full = torch.einsum("bhwk,bk->bhw", onehot, weights)[..., None]
    return ops.resize_bilinear(full, h, w)


class PoseEncoder(nn.Module):
    def __init__(self, cfg: dict, cin: int, p: Precision):
        super().__init__()
        self.p, self.depth = p, len(cfg["pose_channels"])
        for i, ch in enumerate(cfg["pose_channels"]):
            self.add_module(f"enc{i}", ConvBlock(cin, ch, 7 if i == 0 else (5 if i == 1 else 3), 2, p))
            cin = ch

    def forward(self, pair):
        x = self.p.q(pair)
        for i in range(self.depth):
            x = getattr(self, f"enc{i}")(x)
        return x


class PoseHead(nn.Module):
    def __init__(self, cfg: dict, p: Precision):
        super().__init__()
        self.pose_scale = cfg["pose_scale"]
        self.pose_head = Conv(cfg["pose_channels"][-1], 6, 1, 1, p)

    def forward(self, features):
        return self.pose_head(features).mean(dim=(1, 2)) * self.pose_scale


class PoseNet(nn.Module):
    def __init__(self, cfg: dict, extra_channels: int, p: Precision):
        super().__init__()
        self.p = p
        self.encoder = PoseEncoder(cfg, 6 + extra_channels, p)
        self.head = PoseHead(cfg, p)

    def forward(self, target, source, extra, region_weight_fn=None):
        features = self.encoder(torch.cat([target, source, extra], -1))
        if region_weight_fn is not None:
            wmap = region_weight_fn((features.shape[1], features.shape[2]))
            features = self.p.q(features * self.p.q(wmap))
        return self.head(features)


class DispNet(nn.Module):
    """(B, H, W, 3) -> `num_scales` sigmoid disparities, full resolution first."""

    def __init__(self, cfg: dict, p: Precision):
        super().__init__()
        self.p, self.num_scales = p, cfg["num_scales"]
        chans = tuple(cfg["disp_channels"])
        self.depth = len(chans)
        cin = 3
        for i, ch in enumerate(chans):
            self.add_module(f"enc{i}", ConvBlock(cin, ch, 7 if i == 0 else (5 if i == 1 else 3), 2, p))
            self.add_module(f"enc{i}b", ConvBlock(ch, ch, 3, 1, p))
            cin = ch
        self.up_channels = list(chans[::-1][1:]) + [16]
        for i, ch in enumerate(self.up_channels):
            skip_idx = self.depth - 2 - i
            self.add_module(f"dec{i}", ConvBlock(cin, ch, 3, 1, p))
            self.add_module(f"dec{i}b", ConvBlock(ch + (chans[skip_idx] if skip_idx >= 0 else 0), ch, 3, 1, p))
            level = len(self.up_channels) - 1 - i
            if level < self.num_scales:
                self.add_module(f"disp{level}", Conv(ch, 1, 3, 1, p))
            cin = ch

    def forward(self, img):
        x, skips = self.p.q(img), []
        for i in range(self.depth):
            x = getattr(self, f"enc{i}b")(getattr(self, f"enc{i}")(x))
            skips.append(x)
        disps = []
        full_hw = (img.shape[1], img.shape[2])
        for i in range(len(self.up_channels)):
            skip_idx = self.depth - 2 - i
            target_hw = tuple(skips[skip_idx].shape[1:3]) if skip_idx >= 0 else full_hw
            x = getattr(self, f"dec{i}")(ops.upsample_nearest_crop(x, target_hw))
            if skip_idx >= 0:
                x = torch.cat([x, skips[skip_idx]], -1)
            x = getattr(self, f"dec{i}b")(x)
            level = len(self.up_channels) - 1 - i
            if level < self.num_scales:
                disps.append(torch.sigmoid(getattr(self, f"disp{level}")(x)))
        return disps[::-1]


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.5, max_depth: float = 100.0) -> torch.Tensor:
    return min_depth * torch.pow(max_depth / min_depth, disp)


SUPPORTED = {"attention": ("flow_seg",), "attention_cue": ("flow",), "pose_head": ("conv",),
             "disp_encoder": ("conv",), "s2d_first_conv": (False,)}


class DavoModel(nn.Module):
    def __init__(self, cfg: dict, p: Precision, dispnet: bool = False):
        super().__init__()
        for key, allowed in SUPPORTED.items():
            if cfg[key] not in allowed:
                raise ValueError(f"the reference builds {key} in {allowed}, not {cfg[key]!r}")
        ops.exact_float32()
        self.cfg, self.p = cfg, p
        self.posenet = PoseNet(cfg, 3, p)
        self.flownet = FlowNetLite(cfg, p)
        self.attn = RegionAttention(cfg, 2, p)
        if dispnet:
            self.dispnet = DispNet(cfg, p)

    def forward(self, target, sources, seg, train: bool = False, source_disp: bool = False) -> dict:
        """target (B, H, W, 3), sources (B, S, H, W, 3), seg (B, H, W) ->
        poses (B, S, 6), flows (per source, fine first), attn (B, S, K),
        and in training disp (and disp_src: source s at rows s*B..)."""
        B, S = sources.shape[0], sources.shape[1]
        H, W = target.shape[1], target.shape[2]
        out: dict = {}
        flat_src = sources.movedim(1, 0).reshape(S * B, H, W, 3)
        rep_tgt = target.repeat(S, 1, 1, 1)
        k = S // 2 if S > 1 else 1
        offsets = [(i - k if i < k else i - k + 1) / k if S > 1 else -1.0 for i in range(S)]
        dir_plane = torch.cat([target.new_full((B, H, W, 1), o) for o in offsets], 0)
        pyr = self.flownet(rep_tgt, flat_src)
        out["flows"] = [[lv[s * B : (s + 1) * B] for lv in pyr] for s in range(S)]
        flow_full = full_res_flow(pyr[0], H, W)
        weights = self.attn(flow_full)
        out["attn"] = weights.reshape(S, B, -1).movedim(0, 1)
        seg_rep = seg.repeat(S, 1, 1)
        num_classes = self.cfg["num_seg_classes"]

        def region_weight_fn(hw):
            return region_weight_map(weights, seg_rep, num_classes, hw)

        if train:
            if source_disp:
                disps_all = self.dispnet(torch.cat([target, flat_src], 0))
                out["disp"] = [d[:B] for d in disps_all]
                out["disp_src"] = [d[B:] for d in disps_all]
            else:
                out["disp"] = self.dispnet(target)
        pose = self.posenet(rep_tgt, flat_src, torch.cat([dir_plane, flow_full], -1), region_weight_fn)
        out["poses"] = pose.reshape(S, B, 6).movedim(0, 1)
        return out
