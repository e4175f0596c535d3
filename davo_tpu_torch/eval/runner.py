"""Streaming sequence inference: frames -> relative poses -> trajectory
(port of davo_tpu.eval.runner).

Consecutive frame pairs are packed into fixed-size batches, the model
runs each batch on its device, and the increments and the trajectory
are formed on the device too, as the reference does. Frames, seg and
results are numpy on the host. `scan_chunks > 1` packs that many
batches into one call of a `make_pose_apply_scan_fn` closure: one
host-to-device copy per input for the group, the same forward on each
batch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from davo_tpu_torch import resolve_device
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.eval.metrics import (
    ate_rmse,
    kitti_seg_errors,
    snippet_ate,
    snippet_ate_ref,
)


def predict_sequence(
    apply_fn: Callable,
    frames: np.ndarray,
    seg: np.ndarray | None = None,
    batch_size: int = 32,
    scan_chunks: int = 1,
) -> np.ndarray:
    """All consecutive relative poses of a sequence.

    apply_fn(target, source, seg) -> (B, 6) pose vectors as a tensor on
    the model's device (numpy in), e.g. `make_pose_apply_fn(model)`; with
    scan_chunks > 1 a `make_pose_apply_scan_fn(model)` closure taking
    (scan_chunks, B, ...) stacks, the last group padded by repeating its
    last pair and trimmed on return. frames: (N, H, W, 3) float32. The
    increments are formed on that device; returns them as numpy
    (N-1, 4, 4), with poses[k+1] = poses[k] @ rel[k].
    """
    if scan_chunks > 1:
        vecs = _predict_scan(apply_fn, frames, seg, batch_size, scan_chunks)
    else:
        vecs = torch.cat([
            apply_fn(tgt, src, sg)[: end - start]
            for start, end, tgt, src, sg in iter_pair_batches(frames, seg, batch_size)
        ], 0)  # (N-1, 6)
    # vec maps target(k+1) -> source(k): that IS the increment matrix.
    return geo.pose_vec_to_mat(vecs).cpu().numpy()


def _predict_scan(
    apply_fn: Callable, frames: np.ndarray, seg: np.ndarray | None, batch_size: int, scan_chunks: int
) -> torch.Tensor:
    """The pairs packed `scan_chunks` batches at a time into (K, B, ...)
    stacks for a scan closure; (N-1, 6) pose vectors on its device. Each
    group is one `iter_pair_batches` batch of K*B pairs: a view of the
    frames, except the last, padded by repeating its last pair and trimmed
    here."""
    n_pairs = len(frames) - 1

    def chunks(x):
        return x.reshape(scan_chunks, batch_size, *x.shape[1:]) if x is not None else None

    out = [
        apply_fn(chunks(tgt), chunks(src), chunks(sg)).reshape(-1, 6)
        for _, _, tgt, src, sg in iter_pair_batches(frames, seg, scan_chunks * batch_size)
    ]
    return torch.cat(out, 0)[:n_pairs]


def iter_pair_batches(
    frames: np.ndarray,
    seg: np.ndarray | None,
    batch_size: int,
    start0: int = 0,
):
    """Yield (start, end, target, source, seg) fixed-shape pair batches
    from pair `start0` on: targets = frames[1:], seg aligned to the target
    frame, only the final batch padded (by repeating its last pair). The
    one batching contract of `predict_sequence` and the resumable
    `eval.resumable.resumable_predict_sequence`."""
    n_pairs = len(frames) - 1
    targets = frames[1:]
    sources = frames[:-1]
    segs = seg[1:] if seg is not None else None
    for start in range(start0, n_pairs, batch_size):
        end = min(start + batch_size, n_pairs)
        pad = batch_size - (end - start)
        tgt = targets[start:end]
        src = sources[start:end]
        sg = segs[start:end] if segs is not None else None
        if pad:
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, 0)], 0)
            src = np.concatenate([src, np.repeat(src[-1:], pad, 0)], 0)
            if sg is not None:
                sg = np.concatenate([sg, np.repeat(sg[-1:], pad, 0)], 0)
        yield start, end, tgt, src, sg


def assemble_trajectory(rels: np.ndarray, device=None) -> np.ndarray:
    """(N-1, 4, 4) increments -> (N, 4, 4) absolute poses from identity,
    chained on `device` (the GPU unless the caller asks for the CPU)."""
    rel = torch.as_tensor(np.asarray(rels), dtype=torch.float32, device=resolve_device(device))
    return geo.trajectory_from_relatives(rel).cpu().numpy()


def evaluate_sequence(
    pred_poses: np.ndarray, gt_poses: np.ndarray, snippet_len: int = 5
) -> dict:
    """All reference metrics for one sequence."""
    n = min(len(pred_poses), len(gt_poses))
    pred, gt = pred_poses[:n], gt_poses[:n]
    mean_ate, std_ate = snippet_ate(gt, pred, snippet_len)
    ref_mean, ref_std = snippet_ate_ref(gt, pred, snippet_len)
    seg_err = kitti_seg_errors(gt, pred)
    return {
        "ate_full": ate_rmse(gt, pred),
        "snippet_ate_mean": mean_ate,
        "snippet_ate_std": std_ate,
        "snippet_ate_ref_mean": ref_mean,
        "snippet_ate_ref_std": ref_std,
        "t_err_pct": seg_err["t_err_pct"],
        "r_err_deg_per_100m": seg_err["r_err_deg_per_100m"],
        "n_frames": n,
    }


def _serving(model, K):
    """(inputs, poses) of a `DavoModel`'s serving path: `inputs` moves
    numpy targets, sources and seg (used only by attention="flow_seg")
    to the model's device; `poses` runs one forward on a (B, ...) batch
    and returns its (B, 6) float32 pose vectors. K, the sequence's (3, 3)
    intrinsics that pose_head="geo_hybrid" needs, goes to the device once
    (one camera per sequence); the conv head ignores it."""
    device = next(model.parameters()).device
    use_seg = model.cfg.attention == "flow_seg"
    kw = {} if K is None else {"K": torch.as_tensor(np.asarray(K), dtype=torch.float32).to(device)}

    def inputs(targets, sources, seg):
        t = torch.as_tensor(targets, dtype=torch.float32).to(device)
        s = torch.as_tensor(sources, dtype=torch.float32).to(device)
        g = torch.as_tensor(seg).to(device) if use_seg and seg is not None else None
        return t, s, g

    def poses(t, s, g):
        return model(t, s[:, None], seg=g, **kw)["poses"][:, 0].float()

    return inputs, poses


def make_pose_apply_fn(model, K=None) -> Callable:
    """(targets, sources, seg) numpy -> (B, 6) float32 pose tensor on the
    model's device: a closure over a `DavoModel`, run under inference
    mode (see `_serving` for seg and K)."""
    inputs, poses = _serving(model, K)

    def fn(targets, sources, seg=None):
        with torch.inference_mode():
            return poses(*inputs(targets, sources, seg))

    return fn


def make_pose_apply_scan_fn(model, K=None) -> Callable:
    """Chunked serving: (targets, sources, seg) numpy stacks of shape
    (n, B, ...) -> (n, B, 6) float32 pose tensor on the model's device.
    Each stack goes to the device in one copy, then the n batches run
    one forward each, the same forward on the same (B, ...) slice as
    `make_pose_apply_fn`, so the numbers are the per-call path's; nothing
    comes back to the host until the caller reads the result."""
    inputs, poses = _serving(model, K)

    def fn(targets, sources, seg=None):
        with torch.inference_mode():
            t, s, g = inputs(targets, sources, seg)
            return torch.stack([poses(t[i], s[i], None if g is None else g[i]) for i in range(len(t))])

    return fn
