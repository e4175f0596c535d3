"""Typed configuration tree for davo_tpu_torch: davo_tpu.config's fields
and defaults, with comments that leave out the reference's TPU timings.

Replaces the reference's stringly-typed `tf.app.flags` + `--version`
architecture selector (`<ref>/train.py`, SURVEY.md §5 "Config / flag
system") with nested dataclasses; `models/presets.py` maps DAVO-style
version names to full configs so reference ablations stay one flag.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    img_height: int = 128
    img_width: int = 416
    seq_length: int = 3          # frames per snippet (odd, middle = target)
    num_scales: int = 4          # disparity / loss pyramid levels
    num_seg_classes: int = 19    # Cityscapes classes for region attention
    # Network widths (reference-family sizes, lane-aligned where cheap).
    pose_channels: tuple = (16, 32, 64, 128, 256, 256, 256)
    disp_channels: tuple = (32, 64, 128, 256, 512, 512, 512)
    # DispNet encoder family (SURVEY.md R5: the reference's nets.py
    # ships both a plain conv and a ResNet disp encoder, selected by
    # --version): "conv" = stride-2 conv pairs; "resnet" = residual
    # basic blocks (projection shortcuts), same widths/levels so the
    # skip-connected decoder is shared.
    disp_encoder: str = "conv"
    flow_levels: int = 4
    flow_search_range: int = 4
    # >0: 1x1 reduction to this many channels before each estimator's
    # 3x3 stack. The concat input (cost volume + features + flow) is
    # ~115-145 ch; the 3x3s hold ~60 % of the flagship FLOPs, and a
    # 1x1 front halves them (9x cheaper per channel). 0 = paper-parity
    # (no bottleneck).
    flow_est_bottleneck: int = 0
    attention: str = "flow_seg"  # none | flow | flow_seg (paper's full model)
    # What RegionAttention sees (attention == "flow_seg" only).
    # "flow": the forward (target->source) flow field — the paper's cue.
    # "flow_fb": + an occlusion-aware forward-backward consistency
    # channel: run the flow net in BOTH directions and append
    # |fwd(x) + bwd(x + fwd(x))| — near zero where the scene is rigid
    # and visible in both frames, large on occlusions and on
    # independently-moving objects whose two-view flows disagree. A
    # constant-velocity dynamic object fools symmetric-flow cues but
    # not this one. Costs a second flow-net pass (train-time cue
    # quality vs ~2x flow compute); flag-gated pending the TPU
    # ablation (exp_attention_ablation --cue flow_fb).
    attention_cue: str = "flow"
    # Evaluate the channel-starved FIRST stride-2 convs (posenet enc0:
    # 9ch 7x7; flownet feat0a: 3ch 3x3) through the exact
    # space-to-depth rewrite (models/common.conv_same_stride2_s2d) —
    # same params, same math, 4x the contraction depth. The reference
    # found it slower than its native lowering on its TPU
    # (results_r4_s2d.json); default off.
    s2d_first_conv: bool = False
    # Pose head: "conv" = the reference's learned regression head;
    # "geo_hybrid" = dense GN solve of pose from the finest pyramid
    # flow + DispNet depth (models/geopose.py), with the conv head as
    # a learned residual. CANDIDATE, not validated: its first chip
    # arms lost to the conv head (results_r4_quality_geo.json, rot
    # corr ~0); the r5 GT-flow oracle shows the solve itself is exact
    # at these defaults (results_r5_geo_oracle.json), leaving
    # predicted-flow quality as the open bottleneck.
    # geo_hybrid requires attention != "none" and K passed to apply.
    pose_head: str = "conv"
    # Solver defaults are oracle-validated on GT flow (drive + wander
    # eval worlds, tests/test_geopose.py): iters=6 with step_clip=0.5
    # recovers every pair to <0.05 deg; unclipped GN DIVERGES on a few
    # % of drive pairs (overshoot, max 9 deg) regardless of damping —
    # the r4 defaults (iters=4, no clip) shipped that failure mode.
    geo_pose_iters: int = 6
    geo_pose_damping: float = 1e-4
    geo_pose_robust: float = 2.0   # Huber IRLS delta, level pixels
    geo_pose_step_clip: float = 0.5  # per-iteration trust region (6-vec norm)
    pose_scale: float = 0.01     # output scaling, reference convention
    compute_dtype: str = "bfloat16"  # params stay f32; compute in bf16 (MXU)
    # Fused-kernel compute mode, independent of the XLA path's
    # compute_dtype ("" = follow compute_dtype). "bf16_dot" keeps the
    # in-kernel scratch f32 and casts only the MXU dot operands to
    # bf16 — the candidate rewrite for Mosaic's "Bad lhs type"
    # rejection of the bf16 chains (kernels/rowconv._DTYPE_MODES).
    fuse_compute: str = ""
    # The reference's switch to its Pallas cost volume (off by default
    # there). The port always runs its CUDA cost-volume kernel.
    use_pallas: bool = False
    # Serving-only: run each flow estimator's 4-conv chain as ONE
    # fused Pallas kernel in rows layout (kernels/rowconv.py) instead
    # of 4 XLA convs. Same parameters either way (init always builds
    # the XLA tree); pallas_call has no VJP, so keep False for
    # training. Flag-gated pending hardware validation of the rows
    # layout (exp_conv2d_chain phases 1-2).
    fuse_estimator: bool = False
    # TRAINABLE fused estimator: conv_chain_nhwc_ad runs the same
    # 4-conv chain with a hand-written Pallas VJP (forward emits
    # per-layer activations as residuals; the whole backward — relu',
    # db, dW taps, transposed-conv dx — is one more kernel). Grads ==
    # XLA to 1e-3 rel (tests). Unlike the serving flags this may be on
    # during training; flag-gated pending hardware validation.
    fuse_estimator_train: bool = False
    # Serving-only, one step further: the WHOLE flow level — cost
    # volume + ReLU + concat + estimator chain — as one Pallas kernel
    # per level (kernels/rowconv.flow_level_fused), ~55 dispatches ->
    # 1 at search=3. Same param tree; no VJP; requires
    # flow_est_bottleneck == 0. Supersedes fuse_estimator +
    # costvol_impl="pallas_rows" when set.
    fuse_flow_level: bool = False
    # TRAINABLE whole-flow-level fusion: flow_level_fused_ad runs the
    # same one-kernel level with a hand-written VJP (backward = chain
    # reverse + cost-volume transpose to BOTH feature maps, one
    # kernel). Grads == XLA composite (tests). Requires
    # flow_est_bottleneck == 0; may be on during training.
    fuse_flow_level_train: bool = False
    # Serving-only: run the PoseEncoder's stride-2 stack (the even-dim
    # fusable prefix — 5 of 7 layers at 128x416) as ONE Pallas kernel
    # (kernels/rowconv.conv_chain_strided, in-kernel space-to-depth);
    # the odd-dim tail runs via XLA. Same param tree; no VJP.
    fuse_pose_encoder: bool = False
    # Serving-only: RegionAttention's 3x stride-2 conv stack as one
    # Pallas kernel (same mechanism; fully fusable at even inputs).
    fuse_attention: bool = False
    # Serving-only: the whole FlowNetLite feature-pyramid ladder
    # ((s2, s1) x flow_levels) as one multi-output Pallas kernel
    # (conv_chain_strided taps). Requires every s2 layer to see even
    # dims (holds at 128x416); falls back to XLA otherwise.
    fuse_pyramid: bool = False
    # TRAINABLE variants of the three backbone fusions above:
    # conv_chain_strided_ad's hand-written VJP (one backward kernel —
    # window dW dots, transposed-window dx, depth-to-space across
    # stride boundaries, per-tap cotangent injection). Grads == XLA
    # (tests); may be on during training.
    fuse_pose_encoder_train: bool = False
    fuse_attention_train: bool = False
    fuse_pyramid_train: bool = False
    # DispNet "conv" encoder ((s2, s1) pairs with skip taps — the
    # pyramid pattern): serving + trainable fused variants. The
    # even-dim prefix fuses (5 of 7 levels at 128x416); the tail and
    # the skip-concat decoder stay on XLA. No effect on the resnet
    # encoder.
    fuse_disp_encoder: bool = False
    fuse_disp_encoder_train: bool = False
    # Cost-volume lowering: "slices" = (2s+1)^2 fused VPU multiply-
    # reduces; "scan" = the same computation as ONE lax.scan over
    # shifts (kernel-count bound, r2c profile); "gram" = per-row-shift
    # channel Gram matmuls on the MXU with strided-slice diagonal
    # extraction; "patches" = one conv_general_dilated_patches op +
    # one einsum contraction; "pallas_rows" = ALL slices in one Pallas
    # kernel in 2-D rows layout (no transpose/matmul inside — see
    # kernels/costvol.py). All produce identical outputs; the port
    # runs its CUDA kernel for every value.
    costvol_impl: str = "slices"
    # >0: shared learned 1x1 projection of both feature maps to this
    # many channels before correlation (LiteFlowNet-style). The
    # costvol cost scales with C (pyramid features are 32-96 ch);
    # flow quality is gated by the e2e tiers before presets adopt it.
    costvol_feat_channels: int = 0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 4
    learning_rate: float = 2e-4
    beta1: float = 0.9
    # Global-norm gradient clip (0 = off, the reference's behavior).
    # The geo_hybrid pose head can spike gradients through the 6x6
    # solve while the flow net is still random; clip ~10 tames the
    # first few hundred steps without touching converged dynamics.
    grad_clip_norm: float = 0.0
    # "constant" mirrors the reference's fixed-lr Adam; "cosine" decays
    # to lr/100 over max_steps (tighter convergence on short runs).
    lr_schedule: str = "constant"
    max_steps: int = 200_000
    smooth_weight: float = 0.5
    ssim_weight: float = 0.85    # mix: ssim_weight*SSIM + (1-w)*L1
    # Photometric out-of-frame policy. "border" (default): edge-clamped
    # samples, plain mean over all pixels — the reference family's
    # padding mode. "automin": "border" + Monodepth2-style automasking
    # (min with the unwarped-source residual; static/dynamic pixels
    # hit the identity floor and stop pushing depth/pose). "valid":
    # mask out-of-frame pixels and normalize by the valid count; KEEPS
    # a degenerate optimum (empty mask -> loss 0: a TPU run collapsed
    # into it by warping everything out of frame) — ablation only.
    photo_masking: str = "border"
    # Full-resolution multi-scale sampling (Monodepth2 Sec. 3.3):
    # upsample each scale's disparity to input resolution and warp the
    # FULL-RES source with it, instead of warping a downsampled source
    # at scale resolution. Removes the texture-copy artifacts that
    # low-res photometric errors imprint on coarse disparities (the
    # coarse scales otherwise learn to mimic the blurred image, not
    # geometry). Costs num_scales full-res warps per source (~1.6x
    # photometric-loss FLOPs); train-time only. Flag-gated pending TPU
    # e2e validation (training-dynamics conclusions need chip runs).
    photo_fullres: bool = False
    # SC-SfMLearner-style per-image mean normalization of depth inside
    # the photometric + geometry-consistency losses (unsupervised
    # regime only — fights GT translation under pose supervision).
    # Pins every frame's depth to mean 1 so pose translation carries
    # one global scale instead of drifting per snippet (r2 tier B
    # landed at eval scale 0.09).
    depth_norm: bool = False
    # Ramp the photometric gradient INTO DEPTH over the first N steps
    # (loss value unchanged; pose/flow gradients untouched). While
    # poses are still wrong, the photometric landscape prefers
    # depth -> inf everywhere ("shrink the warp toward identity"), and
    # once the disp sigmoid saturates at the cap it cannot recover —
    # measured: the 16-world e2e regime railed depth_med to exactly
    # the 100 m cap inside the first 100 steps (flat disp, smooth=0).
    # 0 disables.
    depth_warmup_steps: int = 250
    # SC-SfMLearner (Bian et al., NeurIPS 2019) geometry-consistency
    # term: project target depth into each source frame and penalize
    # the normalized disagreement with the source's own predicted
    # depth, |d_proj - d_sampled| / (d_proj + d_sampled). Ties the
    # DEPTH SCALE of adjacent frames together, which is the main
    # driver of trajectory-scale drift in the unsupervised regime
    # (t_err on long sequences). >0 enables (and makes the model
    # predict source-frame disparities in the same folded DispNet
    # pass). MEASURED ON CHIP (exp_unsup_geo, r3): 0.5 cuts unsup
    # snippet ATE 0.911 -> 0.698 (-23 %, 1.05x supervised parity) at
    # equal t_err; with depth_norm also on, t_err 62.4 -> 54.6
    # (snippet 0.726). DEFAULT 0.5 since r4 (VERDICT r3 weak #5: the
    # validated recipe must BE the default); the r4 anchors
    # (results_r4_quality.json, wander worlds) are measured with it.
    # depth_norm stays opt-in: it trades snippet ATE (0.698 -> 0.726)
    # for long-horizon t_err (61.6 -> 54.6) and must never be combined
    # with pose supervision (GT translation fights the
    # normalization).
    geo_consistency_weight: float = 0.5
    # Resolution at which each flow level's photometric term is
    # evaluated: "full" upsamples every level's flow and warps the
    # full-res source (r1-r3 behavior); "level" warps an avg-pooled
    # source at the level's own resolution (PWC-family convention),
    # which warps 16-64x fewer pixels per level. Default flipped to
    # "level" after the reference's quality gate passed (exp_quality_ladder4
    # wander_tiny_flowlevel == wander_tiny: t_err 30.93 vs 30.50,
    # r_err 12.84 vs 12.64, snippet 0.854 vs 0.845 — within the
    # arm-to-arm noise band; results_r4_quality.json).
    flow_loss_res: str = "level"
    # >0: supervised Charbonnier end-point error on exact GT flow per
    # pyramid level (losses.flow_supervision_loss; needs a dataset
    # built with with_flow=True — synthetic worlds only). r5 rationale
    # (VERDICT r4 #2): the GT-flow oracle solves pose exactly while
    # every photometric-trained arm's held-out rotation corr is ~0 —
    # train the flow net to GT grade and rotation becomes readable
    # through the geometric head.
    flow_supervision_weight: float = 0.0
    # Bilinear-gather implementation for the loss-path warps
    # (core/warp.bilinear_sample): "take4" (exact gather), "block" (the
    # reference's (2,2,C) gather; runs take4 in the port), "banded"
    # (kernels/bandwarp.py: exact within warp_band, band-edge-clamped
    # beyond; a hand-written CUDA kernel in the port). "auto" resolves
    # at make_train_step time: an explicit DAVO_WARP_GATHER env wins,
    # else per device — "banded" on the accelerator (the reference
    # adopted it after its quality gate, results_r5_warp_gate.json:
    # banded beats take4 on t_err/r_err/snippet in same-window twin
    # arms), "take4" on the CPU.
    warp_gather: str = "auto"
    warp_band: tuple = (4, 16)
    pose_supervision_weight: float = 0.0  # >0 enables GT-pose auxiliary loss
    # Rotation-term multiplier inside the supervised pose L2. At
    # KITTI-scale motions the squared rotation residual is ~10^4
    # smaller than translation's; 10.0 is the historical value (r2
    # artifacts), the r3 quality ladder sweeps it (losses.pose_vec_l2).
    rot_weight: float = 10.0
    # Rematerialize the forward in the backward pass
    # (torch.utils.checkpoint in the port, jax.checkpoint in the reference):
    # trades ~1/3 more FLOPs for dropping all forward activations from
    # HBM, so batch size can grow at fixed memory. Same gradients.
    remat: bool = False
    checkpoint_every: int = 5_000
    log_every: int = 100
    image_every: int = 0  # >0: warped/disparity panels every N steps
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1     # data-parallel axis size
    model: int = 1    # tensor-parallel axis size
    window: int = 1   # BA keyframe-block axis size


@dataclass(frozen=True)
class BAConfig:
    window_size: int = 8         # keyframes per sliding window
    max_iterations: int = 10     # Gauss-Newton outer iterations
    damping: float = 1e-4        # Levenberg-Marquardt lambda
    pcg_iterations: int = 32
    pcg_tol: float = 1e-6
    huber_delta: float = 1.0     # robust loss on reprojection residuals
    outlier_px: float = 16.0     # truncate (zero-weight) residuals beyond


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    ba: BAConfig = field(default_factory=BAConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _coerce(value: Any, current: Any) -> Any:
    """Coerce `value` (often a CLI string) to `current`'s type."""
    if current is None or isinstance(value, type(current)):
        return value
    if isinstance(current, bool):
        return str(value).lower() in ("1", "true", "yes")
    if isinstance(current, tuple):
        parts = value.split(",") if isinstance(value, str) else tuple(value)
        elem = type(current[0]) if current else str
        return tuple(elem(p) for p in parts)
    return type(current)(value)


def _replace_path(node: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(
        node, **{parts[0]: _replace_path(child, parts[1:], value)}
    )


def apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {"model.attention": "none"}.

    Returns a NEW Config built via nested `dataclasses.replace` — the
    input (and any shared preset instance) is never mutated. Values are
    coerced to the current field's type ("true"/"1" -> bool,
    "a,b,c" -> tuple).
    """
    for path, value in overrides.items():
        parts = path.split(".")
        node = cfg
        for p in parts[:-1]:
            node = getattr(node, p)
        current = getattr(node, parts[-1])
        cfg = _replace_path(cfg, parts, _coerce(value, current))
    return cfg
