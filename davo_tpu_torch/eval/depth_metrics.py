"""Eigen-style monocular depth metrics (a copy of
davo_tpu.eval.depth_metrics: numpy only).

Reference parity: the SfMLearner family evaluates `test_kitti_depth.py`
output with `kitti_eval/eval_depth.py` (SURVEY.md R3/R12 [M]):
per-frame median scaling (monocular scale ambiguity), a validity mask
clipped to [min_depth, max_depth] (KITTI convention 1e-3..80 m), then
abs_rel / sq_rel / RMSE / RMSE_log and the delta<1.25^k accuracies.

Numpy host-side like the trajectory metrics (eval is IO-bound).
"""

from __future__ import annotations

import numpy as np

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0


def depth_errors(
    gt: np.ndarray,
    pred: np.ndarray,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
    median_scale: bool = True,
) -> dict:
    """Eigen depth metrics over a batch of frames.

    gt, pred: (N, H, W) (or any matching shape with a leading frame
    axis) positive depths; gt pixels outside [min_depth, max_depth]
    are masked out. With `median_scale`, each frame's prediction is
    rescaled by median(gt)/median(pred) over its own valid mask (the
    standard correction for scale-ambiguous monocular methods).

    Returns dict: abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3,
    scale_med (median of the per-frame scale corrections), n_valid.
    """
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    assert gt.shape == pred.shape, (gt.shape, pred.shape)
    per_frame = []
    scales = []
    n_valid = 0
    for g, p in zip(
        gt.reshape(gt.shape[0], -1), pred.reshape(pred.shape[0], -1)
    ):
        mask = (g > min_depth) & (g < max_depth)
        if not mask.any():
            continue
        g = g[mask]
        p = p[mask]
        if median_scale:
            s = float(np.median(g) / max(np.median(p), 1e-12))
            p = p * s
            scales.append(s)
        # Post-scaling clip mirrors the reference eval: keeps log/ratio
        # terms finite when the net emits ~0 or huge depths.
        p = np.clip(p, min_depth, max_depth)
        thresh = np.maximum(g / p, p / g)
        per_frame.append(
            (
                float(np.mean(np.abs(g - p) / g)),
                float(np.mean(((g - p) ** 2) / g)),
                float(np.sqrt(np.mean((g - p) ** 2))),
                float(np.sqrt(np.mean((np.log(g) - np.log(p)) ** 2))),
                float(np.mean(thresh < 1.25)),
                float(np.mean(thresh < 1.25**2)),
                float(np.mean(thresh < 1.25**3)),
            )
        )
        n_valid += int(mask.sum())
    if not per_frame:
        nan = float("nan")
        return {
            "abs_rel": nan, "sq_rel": nan, "rmse": nan, "rmse_log": nan,
            "a1": nan, "a2": nan, "a3": nan, "scale_med": nan, "n_valid": 0,
        }
    abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 = np.mean(per_frame, 0)
    return {
        "abs_rel": float(abs_rel),
        "sq_rel": float(sq_rel),
        "rmse": float(rmse),
        "rmse_log": float(rmse_log),
        "a1": float(a1),
        "a2": float(a2),
        "a3": float(a3),
        "scale_med": float(np.median(scales)) if scales else 1.0,
        "n_valid": n_valid,
    }
