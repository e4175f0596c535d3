"""Speed-of-light accounting: FLOP/byte rooflines per component (port of
davo_tpu.bench.sol).

The FLOP and byte counts are the reference's, written out. The peaks are
the NVIDIA H100 SXM's (data sheet, dense, at the full 700 W power limit,
as `nvidia-smi` names the card: "NVIDIA H100 80GB HBM3, 700.00 W"); a
card set to a lower power limit runs below them.
"""

from __future__ import annotations

from dataclasses import dataclass

H100_BF16_TFLOPS = 989.0  # tensor cores, dense
H100_HBM_GBPS = 3350.0


@dataclass
class SolReport:
    flops: float
    bytes_accessed: float
    compute_bound_us: float
    memory_bound_us: float
    roofline_us: float
    measured_us: float | None = None

    @property
    def sol_fraction(self) -> float | None:
        if self.measured_us is None:
            return None
        return self.roofline_us / self.measured_us


def conv_stack_sol(shapes: list[tuple], measured_ms: float | None = None) -> SolReport:
    """shapes: [(B, H, W, Cin, Cout, k, stride), ...] per layer."""
    flops = 0.0
    bytes_accessed = 0.0
    for (B, H, W, cin, cout, k, s) in shapes:
        oh, ow = -(-H // s), -(-W // s)
        flops += 2.0 * B * oh * ow * k * k * cin * cout
        bytes_accessed += 2.0 * B * H * W * cin  # bf16 in
        bytes_accessed += 2.0 * B * oh * ow * cout  # bf16 out
        bytes_accessed += 4.0 * k * k * cin * cout  # f32 weights
    compute_us = flops / (H100_BF16_TFLOPS * 1e12) * 1e6
    memory_us = bytes_accessed / (H100_HBM_GBPS * 1e9) * 1e6
    return SolReport(
        flops=flops,
        bytes_accessed=bytes_accessed,
        compute_bound_us=compute_us,
        memory_bound_us=memory_us,
        roofline_us=max(compute_us, memory_us),
        measured_us=None if measured_ms is None else measured_ms * 1000.0,
    )


def model_flops(cfg) -> float:
    """Analytic forward FLOPs of the full pose path (per frame pair):
    pose encoder, flow feature pyramid (x2 images), per-level cost
    volumes (with optional learned projection), flow estimators
    (optional 1x1 bottleneck), and the separable matmul warps.
    `cfg` is a ModelConfig."""
    H, W = cfg.img_height, cfg.img_width
    total = 0.0
    # Pose encoder. Input channels: target(3) + source(3) + the extra
    # cue stack of DavoModel: a 1-ch temporal-direction plane, plus the
    # 2-ch full-res flow when attention != none.
    cin = 7 + (2 if cfg.attention != "none" else 0)
    h, w = H, W
    for i, c in enumerate(cfg.pose_channels):
        k = 7 if i == 0 else (5 if i == 1 else 3)
        h, w = -(-h // 2), -(-w // 2)
        total += 2.0 * h * w * k * k * cin * c
        cin = c
    total += 2.0 * h * w * cfg.pose_channels[-1] * 6  # pose head 1x1
    if cfg.attention == "none":
        return total

    if cfg.attention == "flow_seg":
        # RegionAttention subnet on the (H, W, 2) full-res flow:
        # three stride-2 3x3 convs (16, 32, 64) + two Dense layers.
        ah, aw, acin = H, W, 2
        for ac in (16, 32, 64):
            ah, aw = -(-ah // 2), -(-aw // 2)
            total += 2.0 * ah * aw * 9 * acin * ac
            acin = ac
        total += 2.0 * 64 * 64 + 2.0 * 64 * cfg.num_seg_classes

    level_ch = (16, 32, 64, 96)[: cfg.flow_levels]
    # Feature pyramid x2 images
    cin = 3
    h, w = H, W
    dims = []
    for c in level_ch:
        h, w = -(-h // 2), -(-w // 2)
        total += 2 * (2.0 * h * w * 9 * cin * c + 2.0 * h * w * 9 * c * c)
        dims.append((h, w))
        cin = c

    d2 = (2 * cfg.flow_search_range + 1) ** 2
    proj = cfg.costvol_feat_channels
    bneck = cfg.flow_est_bottleneck
    # Refined levels: pyramid indices 1 .. flow_levels-1
    for lv in range(1, cfg.flow_levels):
        h, w = dims[lv]
        px = h * w
        c = level_ch[lv]
        c_cv = proj if proj > 0 else c
        if proj > 0:  # 1x1 on both maps
            total += 2 * 2.0 * px * c * proj
        total += 2.0 * px * c_cv * d2  # correlation
        # Separable warp (all refined levels except the coarsest,
        # which starts from zero flow): two banded matmuls.
        if lv != cfg.flow_levels - 1:
            total += 2.0 * px * w * c + 2.0 * px * h * c
        # Estimator: optional 1x1 bottleneck + (96, 64, 32) 3x3s + head
        cin_est = d2 + c + 2
        if bneck > 0:
            total += 2.0 * px * cin_est * bneck
            cin_est = bneck
        for cout in (96, 64, 32):
            total += 2.0 * px * 9 * cin_est * cout
            cin_est = cout
        total += 2.0 * px * 9 * 32 * 2
    return total
