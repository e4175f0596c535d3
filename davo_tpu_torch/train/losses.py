"""Loss functions for photometric VO training (port of davo_tpu.train.losses).

* view synthesis: per scale, warp each source into the target view
  through DispNet depth and PoseNet pose; mix SSIM and L1; per-pixel min
  over sources, mean over the frame minus an edge margin ("border" and
  "automin"), or a valid-masked mean ("valid", ablation only);
* edge-aware disparity smoothness, decayed by scale;
* SC-SfMLearner geometry consistency between target and source depths;
* the flow net's photometric loss per pyramid level;
* optional pose and flow supervision.

Every loss-path warp goes through `core.warp.bilinear_sample`, whose
default gather the training loop sets (`banded` on the GPU).
"""

from __future__ import annotations

import torch

from davo_tpu_torch.config import ModelConfig, TrainConfig
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.core.pyramid import image_pyramid
from davo_tpu_torch.core.ssim import ssim
from davo_tpu_torch.core.warp import bilinear_sample, flow_warp, projective_inverse_warp
from davo_tpu_torch.kernels.resize import resize_bilinear_aligned
from davo_tpu_torch.models.dispnet import disp_to_depth
from davo_tpu_torch.models.flownet import FlowNetLite

_EPS = 1e-6


def _gate_depth(depth: torch.Tensor, scale: float) -> torch.Tensor:
    """The same value as `depth`, with its gradient scaled by `scale`
    (the depth warm-up); scale 1.0 leaves depth as it is."""
    if scale == 1.0:
        return depth
    sg = depth.detach()
    return sg + scale * (depth - sg)


def _mean_normalized(depth: torch.Tensor) -> torch.Tensor:
    return depth / (depth.mean(dim=(1, 2), keepdim=True) + _EPS)


def photometric_loss(
    disps: list[torch.Tensor],
    poses: torch.Tensor,
    target: torch.Tensor,
    sources: torch.Tensor,
    K: torch.Tensor,
    ssim_weight: float,
    masking: str = "border",
    depth_grad_scale: float = 1.0,
    fullres: bool = False,
    depth_norm: bool = False,
) -> torch.Tensor:
    """Multi-scale view-synthesis loss.

    disps: num_scales x (B, H/2^s, W/2^s, 1) sigmoid disparities; poses
    (B, S, 6); target (B, H, W, 3); sources (B, S, H, W, 3); K (B, 3, 3)
    at full resolution. `masking`, `fullres` and `depth_norm` as
    `TrainConfig.photo_masking`, `photo_fullres` and `depth_norm`;
    `depth_grad_scale` scales the gradient into depth only.
    """
    num_scales = len(disps)
    H, W = target.shape[1], target.shape[2]
    S = sources.shape[1]
    if fullres:
        tgt_pyr = [target] * num_scales
        src_pyrs = [[sources[:, s]] * num_scales for s in range(S)]
        Ks = [K] * num_scales
    else:
        tgt_pyr = image_pyramid(target, num_scales)
        src_pyrs = [image_pyramid(sources[:, s], num_scales) for s in range(S)]
        Ks = geo.intrinsics_pyramid(K, num_scales)
    fill = "zeros" if masking == "valid" else "border"

    total = 0.0
    for s_idx in range(num_scales):
        disp_s = disps[s_idx]
        if fullres and tuple(disp_s.shape[1:3]) != (H, W):
            disp_s = resize_bilinear_aligned(disp_s, H, W)
        depth = disp_to_depth(disp_s[..., 0])
        if depth_norm:
            depth = _mean_normalized(depth)
        depth = _gate_depth(depth, depth_grad_scale)
        tgt = tgt_pyr[s_idx]
        mixed_per_src = []
        for src_i, src_pyr in enumerate(src_pyrs):
            warped, valid = projective_inverse_warp(
                src_pyr[s_idx], depth, poses[:, src_i], Ks[s_idx], fill=fill
            )
            l1c = (warped - tgt).abs()[:, 1:-1, 1:-1]
            mixed = ssim_weight * ssim(warped, tgt) + (1.0 - ssim_weight) * l1c
            if masking in ("border", "automin"):
                mixed_per_src.append(mixed)
                if masking == "automin":
                    # The unwarped-source residual as a min term, slightly
                    # upweighted so ties keep the gradient on the warp.
                    src_s = src_pyr[s_idx]
                    id_l1 = (src_s - tgt).abs()[:, 1:-1, 1:-1]
                    mixed_per_src.append(
                        1.00001 * (ssim_weight * ssim(src_s, tgt) + (1.0 - ssim_weight) * id_l1)
                    )
            else:
                vc = valid[:, 1:-1, 1:-1]
                total = total + (mixed * vc).sum() / (vc.sum() * 3.0 + _EPS) / len(src_pyrs)
        if masking in ("border", "automin"):
            # Per-pixel min over sources; `amin` splits the gradient of a
            # tie evenly, as `jnp.min` does.
            mn = torch.amin(torch.stack(mixed_per_src, 0), 0)
            m = max(1, round(0.05 * min(mn.shape[1], mn.shape[2])))
            total = total + mn[:, m:-m, m:-m].mean()
    return total / num_scales


def smoothness_loss(disps: list[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness, scale-decayed (w / 2^s)."""
    tgt_pyr = image_pyramid(target, len(disps))
    total = 0.0
    for s, disp in enumerate(disps):
        d = _mean_normalized(disp[..., 0])
        img = tgt_pyr[s]
        dx = (d[:, :, 1:] - d[:, :, :-1]).abs()
        dy = (d[:, 1:, :] - d[:, :-1, :]).abs()
        ix = (img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1)
        iy = (img[:, 1:, :] - img[:, :-1, :]).abs().mean(-1)
        total = total + ((dx * torch.exp(-ix)).mean() + (dy * torch.exp(-iy)).mean()) / (2.0**s)
    return total / len(disps)


def geometry_consistency_loss(
    disp_tgt: torch.Tensor,
    disp_src_flat: torch.Tensor,
    poses: torch.Tensor,
    K: torch.Tensor,
    depth_grad_scale: float = 1.0,
    depth_norm: bool = False,
) -> torch.Tensor:
    """|d_proj - d_samp| / (d_proj + d_samp), masked mean over pixels that
    land in frame with positive z, averaged over sources.

    disp_tgt (B, H, W, 1); disp_src_flat (S*B, H, W, 1), source s at rows
    [s*B, (s+1)*B); poses (B, S, 6); K (B, 3, 3)."""
    B, S = poses.shape[0], poses.shape[1]
    depth_t = disp_to_depth(disp_tgt[..., 0])
    depth_s_all = disp_to_depth(disp_src_flat[..., 0])
    if depth_norm:
        depth_t = _mean_normalized(depth_t)
        depth_s_all = _mean_normalized(depth_s_all)
    depth_t = _gate_depth(depth_t, depth_grad_scale)
    depth_s_all = _gate_depth(depth_s_all, depth_grad_scale)
    total = 0.0
    for s in range(S):
        T = geo.pose_vec_to_mat(poses[:, s])
        uv, z = geo.cam_to_pixel(geo.pixel_to_cam(depth_t, K), K, T)
        d_s = depth_s_all[s * B : (s + 1) * B]
        d_samp, valid = bilinear_sample(d_s[..., None], uv.movedim(-3, -1), fill="zeros")
        d_samp = d_samp[..., 0]
        v = valid[..., 0] * (z > 0.0).to(valid.dtype)
        diff = (z - d_samp).abs() / (z + d_samp + _EPS)
        total = total + (diff * v).sum() / (v.sum() + _EPS)
    return total / S


def pose_vec_l2(poses: torch.Tensor, gt_vec: torch.Tensor, rot_weight: float = 10.0) -> torch.Tensor:
    """L2 between [t, r_euler] pose vectors, rotation weighted up."""
    t_err = ((poses[..., :3] - gt_vec[..., :3]) ** 2).sum(-1)
    r_err = ((poses[..., 3:] - gt_vec[..., 3:]) ** 2).sum(-1)
    return (t_err + rot_weight * r_err).mean()


def pose_supervision_loss(
    poses: torch.Tensor, gt_pose: torch.Tensor, rot_weight: float = 10.0
) -> torch.Tensor:
    """poses (B, S, 6) against GT warp transforms (B, S, 4, 4)."""
    return pose_vec_l2(poses, geo.mat_to_pose_vec(gt_pose), rot_weight)


def flow_losses(
    flow_pyrs: list[list[torch.Tensor]],
    target: torch.Tensor,
    sources: torch.Tensor,
    ssim_weight: float,
    masking: str = "border",
    res_mode: str = "full",
) -> torch.Tensor:
    """Photometric loss of the flow net, per source and pyramid level.

    res_mode "full" upsamples each level's flow and warps the full-res
    source; "level" warps an average-pooled source at the level's own
    resolution (flow values are already in level pixels)."""
    H, W = target.shape[1], target.shape[2]
    if res_mode == "level":
        min_h = min(min(f.shape[1] for f in pyr) for pyr in flow_pyrs)
        depth, h_ = 1, H
        while h_ > min_h:
            h_ = (h_ + 1) // 2
            depth += 1
        tgt_pyr = image_pyramid(target, depth)
        src_pyrs_lv = [image_pyramid(sources[:, s], depth) for s in range(sources.shape[1])]

        def at_res(pyr, h, w):
            for im in pyr:
                if im.shape[1] == h and im.shape[2] == w:
                    return im
            raise ValueError(
                f"no pyramid level at {h}x{w}; have {[tuple(i.shape[1:3]) for i in pyr]}"
            )
    fill = "zeros" if masking == "valid" else "border"
    total = 0.0
    count = 0
    for s_i, pyr in enumerate(flow_pyrs):
        src = sources[:, s_i]
        for flow in pyr:
            if res_mode == "level":
                h, w = flow.shape[1], flow.shape[2]
                tgt_cmp = at_res(tgt_pyr, h, w)
                warped, valid = flow_warp(at_res(src_pyrs_lv[s_i], h, w), flow, fill=fill)
            else:
                warped, valid = flow_warp(src, FlowNetLite.full_res_flow(flow, H, W), fill=fill)
                tgt_cmp = target
            l1 = (warped - tgt_cmp).abs()[:, 1:-1, 1:-1]
            mixed = ssim_weight * ssim(warped, tgt_cmp) + (1.0 - ssim_weight) * l1
            if masking == "valid":
                vc = valid[:, 1:-1, 1:-1]
                total = total + (mixed * vc).sum() / (vc.sum() * 3.0 + _EPS)
            else:
                total = total + mixed.mean()
            count += 1
    return total / max(count, 1)


def flow_supervision_loss(
    flow_pyrs: list[list[torch.Tensor]], gt_flow: torch.Tensor
) -> torch.Tensor:
    """Charbonnier end-point error against GT flow (B, S, H, W, 2) in
    full-res pixels, strided and rescaled to each level's grid."""
    B, S, H, W, _ = gt_flow.shape
    total = 0.0
    count = 0
    for s_i, pyr in enumerate(flow_pyrs):
        g_full = gt_flow[:, s_i]
        for flow in pyr:
            h, w = flow.shape[1], flow.shape[2]
            if H % h or W % w:
                raise ValueError(f"level {h}x{w} does not stride-divide {H}x{W}")
            sy, sx = H // h, W // w
            g = g_full[:, ::sy, ::sx]
            g = torch.stack([g[..., 0] / sx, g[..., 1] / sy], -1)
            d2 = ((flow.float() - g) ** 2).sum(-1)
            total = total + torch.sqrt(d2 + 1e-6).mean()
            count += 1
    return total / max(count, 1)


def total_loss(
    outputs: dict,
    batch: dict,
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    step: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Sum the loss terms: (scalar, metrics of 0-d tensors).

    step: the optimizer step before this update; it drives the depth
    warm-up ramp clip(step / depth_warmup_steps, 0, 1), so at step 0 the
    photometric and geometry terms send no gradient into depth. None
    means no ramp."""
    del mcfg  # the reference's signature; no term reads it
    target, sources, K = batch["target"], batch["sources"], batch["K"]
    metrics: dict = {}

    dgs = 1.0
    if step is not None and tcfg.depth_warmup_steps > 0:
        dgs = min(max(step / float(tcfg.depth_warmup_steps), 0.0), 1.0)
    photo = photometric_loss(
        outputs["disp"], outputs["poses"], target, sources, K, tcfg.ssim_weight,
        masking=tcfg.photo_masking, depth_grad_scale=dgs, fullres=tcfg.photo_fullres,
        depth_norm=tcfg.depth_norm,
    )
    smooth = smoothness_loss(outputs["disp"], target)
    loss = photo + tcfg.smooth_weight * smooth
    metrics["photo"] = photo
    metrics["smooth"] = smooth

    if tcfg.geo_consistency_weight > 0.0 and "disp_src" in outputs:
        gc = geometry_consistency_loss(
            outputs["disp"][0], outputs["disp_src"][0], outputs["poses"], K,
            depth_grad_scale=dgs, depth_norm=tcfg.depth_norm,
        )
        loss = loss + tcfg.geo_consistency_weight * gc
        metrics["geo_consistency"] = gc

    if "flows" in outputs:
        fl = flow_losses(
            outputs["flows"], target, sources, tcfg.ssim_weight,
            masking=tcfg.photo_masking, res_mode=tcfg.flow_loss_res,
        )
        loss = loss + fl
        metrics["flow"] = fl

    if tcfg.flow_supervision_weight > 0.0 and "gt_flow" in batch and "flows" in outputs:
        fs = flow_supervision_loss(outputs["flows"], batch["gt_flow"])
        loss = loss + tcfg.flow_supervision_weight * fs
        metrics["flow_sup"] = fs

    if tcfg.pose_supervision_weight > 0.0 and "gt_pose" in batch:
        sup = pose_supervision_loss(outputs["poses"], batch["gt_pose"], tcfg.rot_weight)
        loss = loss + tcfg.pose_supervision_weight * sup
        metrics["pose_sup"] = sup

    metrics["total"] = loss
    return loss, metrics
