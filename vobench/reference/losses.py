"""The unsupervised training objective in plain PyTorch: multi-scale view
synthesis (SSIM and L1, per-pixel minimum over sources, an edge margin),
edge-aware disparity smoothness, SC-SfMLearner geometry consistency and
the flow net's photometric loss at each level's own resolution. Every
loss-path warp samples through `ops.bilinear_sample` with the
configuration's band (the banded warp), or exactly where it has none.

Only the options the benchmark's configurations use are built: masking
"border", `photo_fullres` and `depth_norm` off, flow loss at "level",
no pose or flow supervision."""

from __future__ import annotations

import torch

from vobench.reference import geometry as geo
from vobench.reference import ops
from vobench.reference.model import disp_to_depth

_EPS = 1e-6

SUPPORTED = {"photo_masking": ("border",), "photo_fullres": (False,), "depth_norm": (False,),
             "flow_loss_res": ("level",), "pose_supervision_weight": (0.0,), "flow_supervision_weight": (0.0,)}


def check_supported(train: dict) -> None:
    for key, allowed in SUPPORTED.items():
        if train[key] not in allowed:
            raise ValueError(f"the reference's loss builds {key} in {allowed}, not {train[key]!r}")


def _gate(depth: torch.Tensor, scale: float) -> torch.Tensor:
    """The same value, its gradient scaled by `scale` (the depth warm-up)."""
    if scale == 1.0:
        return depth
    sg = depth.detach()
    return sg + scale * (depth - sg)


def photometric_loss(disps, poses, target, sources, K, ssim_weight, depth_grad_scale, band):
    num_scales = len(disps)
    S = sources.shape[1]
    tgt_pyr = ops.image_pyramid(target, num_scales)
    src_pyrs = [ops.image_pyramid(sources[:, s], num_scales) for s in range(S)]
    Ks = geo.intrinsics_pyramid(K, num_scales)
    total = 0.0
    for s_idx in range(num_scales):
        depth = _gate(disp_to_depth(disps[s_idx][..., 0]), depth_grad_scale)
        tgt = tgt_pyr[s_idx]
        mixed = []
        for src_i in range(S):
            T = geo.pose_vec_to_mat(poses[:, src_i])
            uv, z = geo.cam_to_pixel(geo.pixel_to_cam(depth, Ks[s_idx]), Ks[s_idx], T)
            warped, _ = ops.bilinear_sample(src_pyrs[src_i][s_idx], uv.movedim(1, -1), "border", band)
            l1 = (warped - tgt).abs()[:, 1:-1, 1:-1]
            mixed.append(ssim_weight * ops.ssim(warped, tgt) + (1.0 - ssim_weight) * l1)
        mn = torch.amin(torch.stack(mixed, 0), 0)
        m = max(1, round(0.05 * min(mn.shape[1], mn.shape[2])))
        total = total + mn[:, m:-m, m:-m].mean()
    return total / num_scales


def smoothness_loss(disps, target):
    tgt_pyr = ops.image_pyramid(target, len(disps))
    total = 0.0
    for s, disp in enumerate(disps):
        d = disp[..., 0]
        d = d / (d.mean(dim=(1, 2), keepdim=True) + _EPS)
        img = tgt_pyr[s]
        dx = (d[:, :, 1:] - d[:, :, :-1]).abs()
        dy = (d[:, 1:, :] - d[:, :-1, :]).abs()
        ix = (img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1)
        iy = (img[:, 1:, :] - img[:, :-1, :]).abs().mean(-1)
        total = total + ((dx * torch.exp(-ix)).mean() + (dy * torch.exp(-iy)).mean()) / (2.0**s)
    return total / len(disps)


def geometry_consistency_loss(disp_tgt, disp_src_flat, poses, K, depth_grad_scale, band):
    B, S = poses.shape[0], poses.shape[1]
    depth_t = _gate(disp_to_depth(disp_tgt[..., 0]), depth_grad_scale)
    depth_s = _gate(disp_to_depth(disp_src_flat[..., 0]), depth_grad_scale)
    total = 0.0
    for s in range(S):
        uv, z = geo.cam_to_pixel(geo.pixel_to_cam(depth_t, K), K, geo.pose_vec_to_mat(poses[:, s]))
        d_samp, valid = ops.bilinear_sample(depth_s[s * B : (s + 1) * B, ..., None], uv.movedim(1, -1), "zeros", band)
        d_samp = d_samp[..., 0]
        v = valid[..., 0] * (z > 0.0).float()
        diff = (z - d_samp).abs() / (z + d_samp + _EPS)
        total = total + (diff * v).sum() / (v.sum() + _EPS)
    return total / S


def flow_losses(flow_pyrs, target, sources, ssim_weight, band):
    """At each level's own resolution: the source average-pooled to the
    level, warped by the level's flow."""
    H = target.shape[1]
    min_h = min(f.shape[1] for pyr in flow_pyrs for f in pyr)
    depth, h_ = 1, H
    while h_ > min_h:
        h_ = (h_ + 1) // 2
        depth += 1
    tgt_pyr = ops.image_pyramid(target, depth)
    src_pyrs = [ops.image_pyramid(sources[:, s], depth) for s in range(sources.shape[1])]

    def at_res(pyr, h, w):
        return next(im for im in pyr if im.shape[1] == h and im.shape[2] == w)

    total, count = 0.0, 0
    for s_i, pyr in enumerate(flow_pyrs):
        for flow in pyr:
            h, w = flow.shape[1], flow.shape[2]
            tgt = at_res(tgt_pyr, h, w)
            grid = geo.pixel_grid(h, w, flow.device)[:2].movedim(0, -1)[None]
            warped, _ = ops.bilinear_sample(at_res(src_pyrs[s_i], h, w), grid + flow, "border", band)
            l1 = (warped - tgt).abs()[:, 1:-1, 1:-1]
            total = total + (ssim_weight * ops.ssim(warped, tgt) + (1.0 - ssim_weight) * l1).mean()
            count += 1
    return total / max(count, 1)


def total_loss(outputs: dict, batch: dict, train: dict, step: int, band) -> tuple[torch.Tensor, dict]:
    """The summed objective of one step and its terms; `step` updates
    applied so far, which drives the depth warm-up."""
    target, sources, K = batch["target"], batch["sources"], batch["K"]
    dgs = 1.0
    if train["depth_warmup_steps"] > 0:
        dgs = min(max(step / float(train["depth_warmup_steps"]), 0.0), 1.0)
    photo = photometric_loss(outputs["disp"], outputs["poses"], target, sources, K, train["ssim_weight"], dgs, band)
    smooth = smoothness_loss(outputs["disp"], target)
    loss = photo + train["smooth_weight"] * smooth
    terms = {"photo": photo, "smooth": smooth}
    if train["geo_consistency_weight"] > 0.0:
        gc = geometry_consistency_loss(outputs["disp"][0], outputs["disp_src"][0], outputs["poses"], K, dgs, band)
        loss = loss + train["geo_consistency_weight"] * gc
        terms["geo_consistency"] = gc
    fl = flow_losses(outputs["flows"], target, sources, train["ssim_weight"], band)
    loss = loss + fl
    terms["flow"] = fl
    return loss, terms
