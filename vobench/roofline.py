"""The least time the benchmarked work could take on one NVIDIA H100 SXM,
from shapes alone: published peaks (NVIDIA's data sheet, dense, at the
full 700 W power limit), each input read once and each output written
once. Frozen copies of the program's `chip_smoke.py` arithmetic
(`_costvol_bound_ms`, `_bound_ms`, the banded warp's byte counts of its
phase 3c, the fused units' bytes and FLOPs of phase 3d).

Every function returns seconds."""

from __future__ import annotations

from vobench.flops import LEVEL_CHANNELS

BF16_FLOPS = 989e12   # tensor cores, dense
F32_FLOPS = 67e12     # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over `peak`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def costvol_s(B: int, H: int, W: int, C: int, search: int, elem: int) -> float:
    """One cost volume: both maps read at `elem` bytes, the float32 volume
    written; the multiply-adds at the float32 rate."""
    D = (2 * search + 1) ** 2
    return bound_s(B * H * W * (2.0 * C * elem + 4.0 * D), 2.0 * B * H * W * D * C, F32_FLOPS)


def serving_costvols_s(cfg: dict, pairs: int) -> float:
    """The unfused forward's cost volumes for `pairs` pairs: one per
    refined level, on bf16 maps (the compute dtype), or on the projected
    maps where the configuration projects them."""
    h, w, total = cfg["img_height"], cfg["img_width"], 0.0
    for lv, c in enumerate(LEVEL_CHANNELS[: cfg["flow_levels"]]):
        h, w = -(-h // 2), -(-w // 2)
        if lv:
            total += costvol_s(pairs, h, w, cfg["costvol_feat_channels"] or c, cfg["flow_search_range"], 2)
    return total


def banded_warp_s(B: int, H: int, W: int, C: int, backward: bool, need_img: bool) -> float:
    """A banded warp's forward (coordinates and image read, output
    written: 8 flops per output element) or backward (coordinates,
    cotangent and image read, coordinate gradients written and, with
    `need_img`, the image gradient: 16 flops per element), float32."""
    if not backward:
        return bound_s(4.0 * B * H * W * (2 + 2 * C), 8.0 * B * H * W * C, F32_FLOPS)
    return bound_s(4.0 * B * H * W * (4 + (3 if need_img else 2) * C), 16.0 * B * H * W * C, F32_FLOPS)


def train_step_warps(cfg: dict, train: dict, B: int) -> list[tuple[int, int, int, int, bool]]:
    """The banded warps of one training step as (B, H, W, C, need_img):
    the view synthesis per scale and source (C=3, frames need no
    gradient), the geometry term per source at full resolution (C=1, the
    source depth does), the flow loss per source and refined level (C=3
    at the level's resolution)."""
    S = cfg["seq_length"] - 1
    H, W = cfg["img_height"], cfg["img_width"]
    warps = []
    h, w = H, W
    for _ in range(cfg["num_scales"]):
        warps += [(B, h, w, 3, False)] * S
        h, w = h // 2, w // 2
    if train["geo_consistency_weight"] > 0.0:
        warps += [(B, H, W, 1, True)] * S
    h, w = H, W
    for lv in range(cfg["flow_levels"]):
        h, w = -(-h // 2), -(-w // 2)
        if lv:
            warps += [(B, h, w, 3, False)] * S
    return warps


def train_step_warps_s(cfg: dict, train: dict, B: int) -> float:
    """The summed bounds of one step's banded warps, forward and backward."""
    return sum(banded_warp_s(b, h, w, c, False, False) + banded_warp_s(b, h, w, c, True, img)
               for b, h, w, c, img in train_step_warps(cfg, train, B))


def _strided_chain_s(N: int, H: int, W: int, cin: int, layers, taps) -> float:
    """A fused stride-2/stride-1 conv chain: the bf16 input read, the
    float32 weights and biases read, the bf16 outputs (each tap, else the
    last layer) written; the bf16 tensor-core rate. `layers` are
    (k, stride, cout)."""
    flops, wbytes, outs = 0.0, 0.0, []
    h, w, c = H, W, cin
    for i, (k, s, cout) in enumerate(layers):
        h, w = -(-h // s), -(-w // s)
        flops += _conv_flops(N, h, w, k, c, cout)
        wbytes += 4.0 * (k * k * c * cout + cout)
        outs.append(2.0 * N * h * w * cout)
        c = cout
    out_bytes = sum(outs[t] for t in taps) if taps else outs[-1]
    return bound_s(2.0 * N * H * W * cin + wbytes + out_bytes, flops, BF16_FLOPS)


def _conv_flops(N, h, w, k, cin, cout):
    return 2.0 * N * h * w * k * k * cin * cout


def _even_prefix(h: int, w: int, n: int) -> int:
    """Stride-2 layers of an n-layer stack that see even dims before the
    first odd one (the part a fused strided chain takes)."""
    done = 0
    while done < n and h % 2 == 0 and w % 2 == 0:
        h, w, done = h // 2, w // 2, done + 1
    return done


def fused_serving_chains_s(cfg: dict, pairs: int) -> float:
    """One fused forward's `conv_chain_strided` and `flow_level_fused`
    calls for `pairs` pairs: the flow pyramid over both images of each
    pair, the attention stack and the pose encoder's even prefix, then
    each refined level (the correlation's maps and the level's features
    read in bf16, the upsampled flow read and the flow increment written in
    float32, the correlation and the estimator chain)."""
    H, W = cfg["img_height"], cfg["img_width"]
    levels = cfg["flow_levels"]
    pyr = [(3, 2, c) if half == 0 else (3, 1, c) for c in LEVEL_CHANNELS[:levels] for half in (0, 1)]
    total = _strided_chain_s(2 * pairs, H, W, 3, pyr, [2 * i + 1 for i in range(levels)])
    n_att = _even_prefix(H, W, 3)
    total += _strided_chain_s(pairs, H, W, 2, [(3, 2, c) for c in (16, 32, 64)][:n_att], None)
    pose = [(7 if i == 0 else (5 if i == 1 else 3), 2, c) for i, c in enumerate(cfg["pose_channels"])]
    n_pose = _even_prefix(H, W, len(pose))
    total += _strided_chain_s(pairs, H, W, 9, pose[:n_pose], None)
    d2 = (2 * cfg["flow_search_range"] + 1) ** 2
    cproj = cfg["costvol_feat_channels"]
    h, w = H, W
    for lv, cf in enumerate(LEVEL_CHANNELS[:levels]):
        h, w = -(-h // 2), -(-w // 2)
        if not lv:
            continue
        cc = cproj or cf
        P = pairs * h * w
        flops = 2.0 * P * d2 * cc
        cin, wbytes = d2 + cf + 2, 0.0
        for cout in (96, 64, 32, 2):
            flops += 2.0 * P * 9 * cin * cout
            wbytes += 4.0 * (9 * cin * cout + cout)
            cin = cout
        # Without a projection the level's features are the correlation's
        # first map, read once.
        nbytes = P * (2.0 * 2 * cc + (2.0 * cf if cproj else 0.0) + 4.0 * 2 + 4.0 * 2) + wbytes
        total += bound_s(nbytes, flops, BF16_FLOPS)
    return total
