"""Operation counts of the DAVO pose path and training step, from a
configuration's shapes alone (frozen here, so that any implementation of
the same work is judged on the same count).

`pose_pair_flops` is the analytic forward count of the pose path per
frame pair written out in the program's `bench/sol.py` (`model_flops`),
copied as it stood; `dispnet_image_flops` and `train_snippet_flops`
extend it with DispNet and the backward pass. A multiply-add counts 2.
"""

from __future__ import annotations

LEVEL_CHANNELS = (16, 32, 64, 96)


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def pose_pair_flops(cfg: dict) -> float:
    """Forward FLOPs of the pose path per frame pair: pose encoder and
    head, region attention, the flow pyramid over both images, each
    refined level's projection, correlation, separable warp and
    estimator."""
    H, W = cfg["img_height"], cfg["img_width"]
    total = 0.0
    cin = 7 + (2 if cfg["attention"] != "none" else 0)
    h, w = H, W
    for i, c in enumerate(cfg["pose_channels"]):
        k = 7 if i == 0 else (5 if i == 1 else 3)
        h, w = -(-h // 2), -(-w // 2)
        total += _conv(h, w, k, cin, c)
        cin = c
    total += 2.0 * h * w * cfg["pose_channels"][-1] * 6
    if cfg["attention"] == "none":
        return total
    if cfg["attention"] == "flow_seg":
        ah, aw, acin = H, W, 2
        for ac in (16, 32, 64):
            ah, aw = -(-ah // 2), -(-aw // 2)
            total += _conv(ah, aw, 3, acin, ac)
            acin = ac
        total += 2.0 * 64 * 64 + 2.0 * 64 * cfg["num_seg_classes"]
    level_ch = LEVEL_CHANNELS[: cfg["flow_levels"]]
    cin, h, w, dims = 3, H, W, []
    for c in level_ch:
        h, w = -(-h // 2), -(-w // 2)
        total += 2 * (_conv(h, w, 3, cin, c) + _conv(h, w, 3, c, c))
        dims.append((h, w))
        cin = c
    d2 = (2 * cfg["flow_search_range"] + 1) ** 2
    proj, bneck = cfg["costvol_feat_channels"], cfg["flow_est_bottleneck"]
    for lv in range(1, cfg["flow_levels"]):
        h, w = dims[lv]
        px, c = h * w, level_ch[lv]
        c_cv = proj if proj > 0 else c
        if proj > 0:
            total += 2 * 2.0 * px * c * proj
        total += 2.0 * px * c_cv * d2
        if lv != cfg["flow_levels"] - 1:
            total += 2.0 * px * w * c + 2.0 * px * h * c
        cin_est = d2 + c + 2
        if bneck > 0:
            total += 2.0 * px * cin_est * bneck
            cin_est = bneck
        for cout in (96, 64, 32):
            total += 2.0 * px * 9 * cin_est * cout
            cin_est = cout
        total += 2.0 * px * 9 * 32 * 2
    return total


def correlation_pair_flops(cfg: dict) -> float:
    """The cost volumes' part of `pose_pair_flops` (elementwise work, not
    a convolution or matrix product)."""
    H, W = cfg["img_height"], cfg["img_width"]
    d2 = (2 * cfg["flow_search_range"] + 1) ** 2
    total, h, w = 0.0, H, W
    for lv, c in enumerate(LEVEL_CHANNELS[: cfg["flow_levels"]]):
        h, w = -(-h // 2), -(-w // 2)
        if lv:
            total += 2.0 * h * w * (cfg["costvol_feat_channels"] or c) * d2
    return total


def _dispnet_layers(cfg: dict) -> list[tuple[int, int, int, int, int]]:
    """DispNet's convolutions as (out h, out w, k, cin, cout), encoder first."""
    H, W = cfg["img_height"], cfg["img_width"]
    chans = tuple(cfg["disp_channels"])
    layers, dims = [], []
    cin, h, w = 3, H, W
    for i, ch in enumerate(chans):
        h, w = -(-h // 2), -(-w // 2)
        layers += [(h, w, 7 if i == 0 else (5 if i == 1 else 3), cin, ch), (h, w, 3, ch, ch)]
        dims.append((h, w))
        cin = ch
    up = list(chans[::-1][1:]) + [16]
    for i, ch in enumerate(up):
        skip = len(chans) - 2 - i
        h, w = dims[skip] if skip >= 0 else (H, W)
        layers += [(h, w, 3, cin, ch), (h, w, 3, ch + (chans[skip] if skip >= 0 else 0), ch)]
        if len(up) - 1 - i < cfg["num_scales"]:
            layers.append((h, w, 3, ch, 1))
        cin = ch
    return layers


def dispnet_image_flops(cfg: dict) -> float:
    """Forward FLOPs of DispNet on one image."""
    return sum(_conv(*layer) for layer in _dispnet_layers(cfg))


def train_snippet_flops(cfg: dict, train: dict) -> float:
    """FLOPs of one snippet (a target and S = seq_length - 1 sources)
    through the training step's convolutions and matrix products: the
    forward (S pose-path pairs, DispNet on the target and, with geometry
    consistency, on each source), and the backward at twice the forward,
    less the input gradients of the two layers that read the frames
    (DispNet's first layer and the flow pyramid's), which no one asks
    for. The cost volumes are left out (elementwise, not matrix work)."""
    S = cfg["seq_length"] - 1
    images = 1 + (S if train["geo_consistency_weight"] > 0.0 else 0)
    forward = S * (pose_pair_flops(cfg) - correlation_pair_flops(cfg)) + images * dispnet_image_flops(cfg)
    H, W = cfg["img_height"], cfg["img_width"]
    first_disp = _conv(*_dispnet_layers(cfg)[0])
    first_pyramid = _conv(-(-H // 2), -(-W // 2), 3, 3, LEVEL_CHANNELS[0])
    return 3.0 * forward - images * first_disp - 2 * S * first_pyramid
