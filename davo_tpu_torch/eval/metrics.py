"""Trajectory metrics: ATE (scale-aligned) and KITTI t_err/r_err.

Numpy host-side (eval is IO-bound; device compute is the model).

KITTI segment-error semantics follow the odometry devkit
(`<ref>/kitti_benchmark/evaluate_odometry.cpp`, SURVEY.md R13 [H]):
for each start frame (every `step` frames) and each segment length in
{100..800} m of driven path, the relative-pose error
``E = inv(inv(gt_i) gt_j) (inv(pred_i) pred_j)`` contributes
``t_err = |trans(E)| / len`` and ``r_err = angle(E) / len``.
"""

from __future__ import annotations

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative driven path length per frame. poses: (N, 4, 4)."""
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def _rotation_angle(R: np.ndarray) -> float:
    """atan2 form: well-conditioned near 0 where acos(trace) loses
    ~half the float digits (matters for near-perfect trajectories)."""
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_t = 0.5 * np.linalg.norm(vee)
    return float(np.arctan2(sin_t, cos_t))


def kitti_seg_errors(
    gt: np.ndarray,
    pred: np.ndarray,
    lengths: tuple = KITTI_LENGTHS,
    step: int = 10,
) -> dict:
    """KITTI odometry benchmark errors.

    gt, pred: (N, 4, 4) absolute poses (same frame indexing).
    Returns dict with t_err (%), r_err (deg per 100 m), and the raw
    per-segment list [(first_frame, len, t_err, r_err), ...].
    """
    assert gt.shape == pred.shape
    dist = trajectory_distances(gt)
    segments = []
    for first in range(0, len(gt), step):
        for seg_len in lengths:
            target = dist[first] + seg_len
            # Official devkit tie semantics: first frame STRICTLY past
            # the target distance (lastFrameFromSegmentLength uses
            # `dist[i] > ...`); side="right" matches. Measure-zero on
            # real float trajectories, but synthetic worlds with round
            # step lengths hit exact ties.
            j = int(np.searchsorted(dist, target, side="right"))
            if j >= len(gt):
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[j]
            pred_rel = np.linalg.inv(pred[first]) @ pred[j]
            E = np.linalg.inv(gt_rel) @ pred_rel
            t_err = np.linalg.norm(E[:3, 3]) / seg_len
            r_err = _rotation_angle(E[:3, :3]) / seg_len
            segments.append((first, seg_len, t_err, r_err))
    if not segments:
        return {"t_err_pct": np.nan, "r_err_deg_per_100m": np.nan, "segments": []}
    t = np.mean([s[2] for s in segments])
    r = np.mean([s[3] for s in segments])
    return {
        "t_err_pct": 100.0 * t,
        "r_err_deg_per_100m": np.degrees(r) * 100.0,
        "segments": segments,
    }


def align_trajectory_scale(
    gt: np.ndarray, pred: np.ndarray
) -> tuple[np.ndarray, float]:
    """Globally scale `pred` translations to best fit `gt` (monocular
    scale ambiguity — the standard correction before t_err on
    unsupervised methods; rotations are scale-free and untouched)."""
    gt_c = gt[:, :3, 3] - gt[:, :3, 3].mean(0)
    pr_c = pred[:, :3, 3] - pred[:, :3, 3].mean(0)
    denom = float((pr_c * pr_c).sum())
    scale = float((gt_c * pr_c).sum()) / denom if denom > 1e-12 else 1.0
    out = pred.copy()
    out[:, :3, 3] *= scale
    return out, scale


def ate_rmse(
    gt: np.ndarray, pred: np.ndarray, align_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after translation (+scale) alignment.

    gt, pred: (N, 4, 4) or (N, 3) positions. Alignment matches the
    reference's snippet evaluation: subtract the first (or mean) offset
    and least-squares-fit a single scale (monocular scale ambiguity).
    """
    gt_p = gt[:, :3, 3] if gt.ndim == 3 else gt
    pr_p = pred[:, :3, 3] if pred.ndim == 3 else pred
    gt_c = gt_p - gt_p.mean(0)
    pr_c = pr_p - pr_p.mean(0)
    if align_scale:
        denom = float((pr_c * pr_c).sum())
        scale = float((gt_c * pr_c).sum()) / denom if denom > 1e-12 else 1.0
        pr_c = pr_c * scale
    err = gt_c - pr_c
    return float(np.sqrt((err**2).sum(-1).mean()))


def compute_ate_ref(gt: np.ndarray, pred: np.ndarray) -> float:
    """The SfMLearner-lineage `compute_ate` EXACTLY (reference
    `kitti_eval/pose_evaluation_utils.py` semantics): align the FIRST
    frame by offset, least-squares scale on the offset trajectory,
    then sqrt(SUM of squared errors) / N — NOT an RMSE (it is ~1/√N
    of one). Published SfMLearner/DAVO ATE tables use this form;
    `ate_rmse` above is the statistically conventional variant, kept
    because recorded r1/r2 artifacts pin its values.
    """
    gt_p = gt[:, :3, 3] if gt.ndim == 3 else np.asarray(gt, float)
    pr_p = pred[:, :3, 3] if pred.ndim == 3 else np.asarray(pred, float)
    pr_p = pr_p + (gt_p[0] - pr_p[0])[None, :]
    denom = float((pr_p * pr_p).sum())
    scale = float((gt_p * pr_p).sum()) / denom if denom > 1e-12 else 1.0
    err = pr_p * scale - gt_p
    return float(np.sqrt((err**2).sum()) / len(gt_p))


def snippet_ate(
    gt: np.ndarray, pred: np.ndarray, snippet_len: int = 5
) -> tuple[float, float]:
    """Mean and std of per-snippet scale-aligned ATE over a sequence.

    Reference: `<ref>/kitti_eval/eval_pose.py` — each `snippet_len`-frame
    window aligned independently (SURVEY.md R12). Uses `ate_rmse`
    (mean-centered true RMSE); for numbers comparable to published
    SfMLearner/DAVO tables use `snippet_ate_ref`.

    Sequences shorter than `snippet_len` have no snippets: returns
    (nan, nan) explicitly (no empty-mean warning).
    """
    return _snippet_stats(ate_rmse, gt, pred, snippet_len)


def snippet_ate_ref(
    gt: np.ndarray, pred: np.ndarray, snippet_len: int = 5
) -> tuple[float, float]:
    """`snippet_ate` with the reference-exact `compute_ate_ref` per
    snippet — the number to quote against published DAVO/SfMLearner
    ATE tables."""
    return _snippet_stats(compute_ate_ref, gt, pred, snippet_len)


def _snippet_stats(metric, gt, pred, snippet_len) -> tuple[float, float]:
    vals = [
        metric(gt[i : i + snippet_len], pred[i : i + snippet_len])
        for i in range(0, len(gt) - snippet_len + 1)
    ]
    if not vals:
        return float("nan"), float("nan")
    return float(np.mean(vals)), float(np.std(vals))
