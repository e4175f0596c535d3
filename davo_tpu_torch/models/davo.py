"""DavoModel: the DAVO forward pass (port of davo_tpu.models.davo).

    (I_src, I_tgt) -> FlowNetLite -> flow pyramid
    flow (+seg) -> RegionAttention -> 19 region weights
    (I_tgt, I_src, direction, flow) -> PoseNet -> 6-DoF xi * pose_scale
    I_tgt (+ I_src) -> DispNet -> multi-scale disparity   (train=True)

The serving flags `fuse_pyramid`, `fuse_flow_level`, `fuse_attention`,
`fuse_pose_encoder`, `fuse_estimator` and `fuse_disp_encoder` run the
fused kernels of `kernels/rowconv.py` (forward only); their `_train`
variants run the differentiable chains of `kernels/rowconv_ad.py`.
`pose_head="geo_hybrid"` adds the dense Gauss-Newton pose of
`models/geopose.py` (finest flow level, DispNet depth of the target,
which serving then runs too) with the conv head as a residual on it; it
needs the flow net and the camera K.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from davo_tpu_torch import exact_f32, resolve_device
from davo_tpu_torch.config import ModelConfig
from davo_tpu_torch.core.warp import flow_warp_separable
from davo_tpu_torch.kernels.resize import resize_bilinear_aligned
from davo_tpu_torch.kernels.rowconv import DTYPE_MODES
from davo_tpu_torch.models.attention import RegionAttention, region_weight_map
from davo_tpu_torch.models.common import lecun_init_
from davo_tpu_torch.models.dispnet import DispNet, disp_to_depth
from davo_tpu_torch.models.flownet import FlowNetLite
from davo_tpu_torch.models.geopose import pose_from_flow_pyramid
from davo_tpu_torch.models.posenet import PoseNet


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for option values the model does not know."""
    if cfg.fuse_compute and cfg.fuse_compute not in DTYPE_MODES:
        raise ValueError(f"unknown fuse_compute {cfg.fuse_compute!r}")
    if cfg.pose_head not in ("conv", "geo_hybrid"):
        raise ValueError(f"unknown pose_head {cfg.pose_head!r}")
    if cfg.attention not in ("none", "flow", "flow_seg"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.attention_cue not in ("flow", "flow_fb"):
        raise ValueError(f"unknown attention_cue {cfg.attention_cue!r}")


class DavoModel(nn.Module):
    """Built with Flax's default init from `seed` on `device` (the GPU
    unless device="cpu"); `convert.load_flax_params` loads a reference
    parameter tree instead. `dispnet=True` adds the DispNet that the
    training forward runs: its parameters are in a reference tree made
    by a training init, not in one made with train=False. The geo_hybrid
    head always has it, as its serving forward runs it."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device | None = None,
                 seed: int = 0, dispnet: bool = False):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        exact_f32()
        self.cfg = cfg
        use_flow = cfg.attention != "none"
        self.posenet = PoseNet(cfg, extra_channels=1 + (2 if use_flow else 0))
        if use_flow:
            self.flownet = FlowNetLite(cfg)
        if cfg.attention == "flow_seg":
            self.attn = RegionAttention(cfg, 3 if cfg.attention_cue == "flow_fb" else 2)
        if dispnet or cfg.pose_head == "geo_hybrid":
            self.dispnet = DispNet(cfg)
        lecun_init_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(
        self,
        target: torch.Tensor,
        sources: torch.Tensor,
        seg: torch.Tensor | None = None,
        train: bool = False,
        source_disp: bool = False,
        K: torch.Tensor | None = None,
    ) -> dict[str, Any]:
        """target: (B, H, W, 3); sources: (B, S, H, W, 3); seg: (B, H, W)
        int labels (used with attention="flow_seg"); K: (3, 3) or
        (B, 3, 3) intrinsics, which pose_head="geo_hybrid" needs.

        Returns poses (B, S, 6), flows (per-source flow pyramids, when
        attention != "none"), attn ((B, S, K), attention="flow_seg") and,
        with train=True, disp (num_scales x (B, H/2^s, W/2^s, 1)); with
        source_disp also disp_src (S*B rows, source s at [s*B, (s+1)*B)),
        from one DispNet pass over target and sources; with geo_hybrid
        pose_geo (B, S, 6), the geometric estimate that poses adds the
        conv head's output to.
        """
        if train and not hasattr(self, "dispnet"):
            raise ValueError("train=True needs a DavoModel built with dispnet=True")
        cfg = self.cfg
        B, S = sources.shape[0], sources.shape[1]
        H, W = target.shape[1], target.shape[2]
        out: dict[str, Any] = {}

        # Batch-fold the sources: source s occupies rows [s*B, (s+1)*B).
        flat_src = sources.movedim(1, 0).reshape(S * B, H, W, 3)
        rep_tgt = target.repeat(S, 1, 1, 1)

        # Temporal-direction plane: sources are ordered
        # [t-k..t-1, t+1..t+k]; offset in [-1, 1].
        k = S // 2 if S > 1 else 1
        offsets = [
            (i - k if i < k else i - k + 1) / k if S > 1 else -1.0 for i in range(S)
        ]
        dir_plane = torch.cat(
            [target.new_full((B, H, W, 1), o) for o in offsets], 0
        )

        extra = dir_plane
        region_weight_fn = None
        if cfg.attention != "none":
            pyr = self.flownet(rep_tgt, flat_src)
            out["flows"] = [[lv[s * B : (s + 1) * B] for lv in pyr] for s in range(S)]
            flow_full = FlowNetLite.full_res_flow(pyr[0], H, W)
            extra = torch.cat([dir_plane, flow_full], -1)
            if cfg.attention == "flow_seg":
                attn_in = flow_full
                if cfg.attention_cue == "flow_fb":
                    attn_in = torch.cat([flow_full, self._fb_cue(pyr[0], rep_tgt, flat_src, H, W)], -1)
                weights = self.attn(attn_in)  # (S*B, K)
                out["attn"] = weights.reshape(S, B, -1).movedim(0, 1)
                if seg is not None:
                    seg_rep = seg.repeat(S, 1, 1)
                    region_weight_fn = lambda hw: region_weight_map(  # noqa: E731
                        weights, seg_rep, cfg.num_seg_classes, hw
                    )

        need_geo = cfg.pose_head == "geo_hybrid"
        disps_t = None
        if train:
            if source_disp:
                disps_all = self.dispnet(torch.cat([target, flat_src], 0))
                out["disp"] = [d[:B] for d in disps_all]
                out["disp_src"] = [d[B:] for d in disps_all]
            else:
                out["disp"] = self.dispnet(target)
            disps_t = out["disp"]
        elif need_geo:
            disps_t = self.dispnet(target)

        pose_flat = self.posenet(rep_tgt, flat_src, extra=extra, region_weight_fn=region_weight_fn)
        if need_geo:
            # The dense GN pose on the finest flow level and the target's
            # DispNet depth; the conv head becomes a residual on it.
            if cfg.attention == "none":
                raise ValueError("pose_head='geo_hybrid' needs the flow net (attention != 'none')")
            if K is None:
                raise ValueError("pose_head='geo_hybrid' requires K")
            depth_rep = disp_to_depth(disps_t[0][..., 0].float()).repeat(S, 1, 1)
            Kr = K.repeat(S, 1, 1) if K.dim() == 3 else K
            geo_vec = pose_from_flow_pyramid(
                pyr[0].float(), depth_rep, Kr, (H, W), iters=cfg.geo_pose_iters,
                damping=cfg.geo_pose_damping, robust_delta=cfg.geo_pose_robust,
                step_clip=cfg.geo_pose_step_clip,
            )
            out["pose_geo"] = geo_vec.reshape(S, B, 6).movedim(0, 1)
            pose_flat = pose_flat + geo_vec.to(pose_flat.dtype)
        out["poses"] = pose_flat.reshape(S, B, 6).movedim(0, 1)
        return out

    def _fb_cue(self, fwd4, rep_tgt, flat_src, H, W):
        """|fwd(x) + bwd(x + fwd(x))| at the /4 level, upsampled to (H, W):
        near zero where the point is rigid and seen in both frames."""
        bwd4 = self.flownet(flat_src, rep_tgt)[0]
        bwd_at_fwd, _ = flow_warp_separable(bwd4, fwd4)
        # Rescale per axis before the norm: du by W/w4, dv by H/h4.
        scale = torch.tensor(
            [W / fwd4.shape[2], H / fwd4.shape[1]], dtype=torch.float32, device=fwd4.device
        )
        resid = (fwd4 + bwd_at_fwd) * scale
        fb4 = torch.sqrt((resid * resid).sum(-1, keepdim=True) + 1e-8)
        return resize_bilinear_aligned(fb4, H, W)
