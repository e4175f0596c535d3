"""Snippet dataset: fixed-length frame windows -> fixed-shape batches
(a copy of davo_tpu.data.snippets; the augmentation's resizes are
NumPy here: `_resize_linear`, `imageio.resize_nearest`).

Reference parity: `<ref>/data_loader.py` `load_train_batch` — 3-frame
snippets (target = middle frame, sources = neighbors), per-snippet
intrinsics, random scale/crop/color augmentation (SURVEY.md R9 [H]).

Batches are plain dicts of fixed-shape float32 numpy arrays (NHWC);
augmentation runs on the host in numpy; `prefetch.device_prefetch`
moves them to the device.

A "source sequence" is anything with:
    __len__ / frame(i) -> (H, W, 3) float32
    K (3, 3) intrinsics at frame resolution
    optionally seg(i) -> (H, W) int32, gt_rel(i) -> (4, 4)
(`SyntheticSequence` natively; `KittiOdometry` via `KittiAdapter`.)
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from davo_tpu_torch.data.imageio import resize_nearest


def _linear_taps(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray]:
    """Source index and weight of the upper tap per output index:
    half-pixel centres, clamped at both edges (OpenCV's INTER_LINEAR)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i
    f[i < 0] = 0.0
    i[i < 0] = 0
    top = i >= n_in - 1
    f[top] = 0.0
    i[top] = n_in - 1
    return i, f.astype(np.float32)


def _resize_linear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float32 image to (nh, nw, C), as
    `cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)` computes
    it (rows first, then columns, in float32)."""
    H, W = img.shape[:2]
    xi, xf = _linear_taps(nw, W)
    yi, yf = _linear_taps(nh, H)
    x1 = np.minimum(xi + 1, W - 1)
    y1 = np.minimum(yi + 1, H - 1)
    xf = xf[:, None]
    rows = img[:, xi] * (1.0 - xf) + img[:, x1] * xf  # (H, nw, C)
    yf = yf[:, None, None]
    return (rows[yi] * (1.0 - yf) + rows[y1] * yf).astype(np.float32)


def apply_scale_crop(
    frames: list[np.ndarray],
    seg: "np.ndarray | None",
    K: np.ndarray,
    s: float,
    oy: int,
    ox: int,
) -> tuple[list[np.ndarray], "np.ndarray | None", np.ndarray]:
    """Reference `data_augmentation` (SURVEY.md R9): upscale by `s`,
    crop back to native size at offset (oy, ox); shared across the
    snippet; intrinsics follow (focal scaled, principal point shifted
    by the crop) so GT poses stay valid — scaling + cropping an image
    is purely an intrinsics change."""
    H, W = frames[0].shape[:2]
    nh, nw = int(np.ceil(H * s)), int(np.ceil(W * s))
    if (nh, nw) == (H, W):
        return frames, seg, K
    frames = [_resize_linear(f, nh, nw)[oy : oy + H, ox : ox + W] for f in frames]
    if seg is not None:
        seg = resize_nearest(seg.astype(np.uint8), nh, nw)[
            oy : oy + H, ox : ox + W
        ].astype(np.int32)
    K = K.copy()
    sx, sy = nw / W, nh / H
    K[0, 0] *= sx
    K[1, 1] *= sy
    K[0, 2] = K[0, 2] * sx - ox
    K[1, 2] = K[1, 2] * sy - oy
    return frames, seg, K


def augment_batches(batches, mode=True, seed: int = 0):
    """Train-time augmentation for PRE-BATCHED pipelines (the prepared
    layout's python/native readers yield raw batches; `SnippetDataset`
    augments per snippet internally — reference parity: the reference
    augments its prepared triplets inside `data_loader.py`).

    Per item: shared gamma/brightness/color jitter across target +
    sources (photometric consistency), and — unless mode == "color" —
    the random zoom/crop with intrinsics follow-through
    (`apply_scale_crop`; gt_pose stays valid, the zoom is purely a K
    change). Color jitter is vectorized over the batch; zoom/crop runs
    per item (`_resize_linear`, `imageio.resize_nearest`).
    """
    rng = np.random.default_rng(seed)
    for batch in batches:
        tgt = batch["target"]
        src = batch["sources"]
        B = tgt.shape[0]
        gamma = rng.uniform(0.8, 1.2, (B, 1, 1, 1)).astype(np.float32)
        bright = rng.uniform(0.8, 1.2, (B, 1, 1, 1)).astype(np.float32)
        color = rng.uniform(0.9, 1.1, (B, 1, 1, 3)).astype(np.float32)
        out = dict(batch)
        out["target"] = np.clip(tgt**gamma * bright * color, 0.0, 1.0)
        out["sources"] = np.clip(
            src ** gamma[:, None] * bright[:, None] * color[:, None],
            0.0,
            1.0,
        ).astype(np.float32)
        if mode != "color":
            K = batch["K"].copy()
            seg = batch.get("seg")
            new_seg = None if seg is None else seg.copy()
            H, W = tgt.shape[1], tgt.shape[2]
            for i in range(B):
                s = float(rng.uniform(1.0, 1.15))
                nh, nw = int(np.ceil(H * s)), int(np.ceil(W * s))
                oy = int(rng.integers(0, nh - H + 1))
                ox = int(rng.integers(0, nw - W + 1))
                frames = [out["target"][i]] + list(out["sources"][i])
                sg = None if seg is None else seg[i]
                frames, sg, Ki = apply_scale_crop(
                    frames, sg, K[i], s, oy, ox
                )
                out["target"][i] = frames[0]
                out["sources"][i] = np.stack(frames[1:], 0)
                K[i] = Ki
                if new_seg is not None:
                    new_seg[i] = sg
            out["K"] = K
            if new_seg is not None:
                out["seg"] = new_seg
        yield out


def snippet_indices(n_frames: int, seq_length: int = 3, stride: int = 1) -> list[int]:
    """Target-frame indices t such that [t-k, t+k] fits in the sequence."""
    k = seq_length // 2
    return list(range(k, n_frames - k, stride))


@dataclass
class KittiAdapter:
    """Adapts `KittiOdometry` to the snippet-source protocol at a fixed
    resolution (resize + intrinsics rescale done once here)."""

    seq: "object"
    height: int
    width: int
    native_hw: tuple[int, int]

    def __post_init__(self):
        self.K = self.seq.scaled_intrinsics(self.height, self.width, self.native_hw)
        # Expose seg(i) only when the sequence ships precomputed label
        # maps (SnippetDataset keys off hasattr) — instance attribute,
        # not a class method, so absence is detectable.
        if getattr(self.seq, "seg_dir", None):
            self.seg = self._seg

    def __len__(self):
        return len(self.seq)

    def frame(self, i):
        return self.seq.load_frame(i, self.height, self.width)

    def _seg(self, i):
        return self.seq.load_seg(i, self.height, self.width)

    def gt_rel(self, i):
        gt = self.seq.gt_poses
        if gt is None:
            return None
        return np.linalg.inv(gt[i]) @ gt[i + 1]


class SnippetDataset:
    """Iterates shuffled fixed-shape snippet batches from a source sequence."""

    def __init__(
        self,
        source,
        batch_size: int = 4,
        seq_length: int = 3,
        with_seg: bool = False,
        with_gt: bool = False,
        with_flow: bool = False,
        augment: bool = False,
        seed: int = 0,
    ):
        assert seq_length % 2 == 1, "seq_length must be odd (middle target)"
        self.source = source
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.with_seg = with_seg and hasattr(source, "seg")
        # GT flow needs an exact-flow source (the synthetic worlds'
        # gt_flow(i, j)); real sequences silently lack it.
        self.with_flow = with_flow and hasattr(source, "gt_flow")
        if self.with_flow and augment and augment != "color":
            raise ValueError(
                "with_flow requires augment in (False, 'color'): the "
                "zoom+crop augment changes pixel geometry and would "
                "invalidate the precomputed GT flow"
            )
        self.with_gt = with_gt
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.indices = snippet_indices(len(source), seq_length)
        # LRU-bounded decode cache: unbounded, a 4,541-frame KITTI
        # sequence at 128x416 f32 pins ~2.9 GB of host RAM. 512 frames
        # (~330 MB) covers shuffled-batch reuse within an epoch slice.
        self.max_cached_frames = 512
        self._frame_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        # GT flow is recomputed analytically per (target, source) pair
        # (one _surfaces render + a projection); snippets repeat ~100x
        # over a 2,500-step epoch on 16 tiny worlds, so cache like
        # frames. 256 pairs at 48x64 f32x2 ~ 6 MB; at 128x416 ~ 109 MB.
        self.max_cached_flows = 256
        self._flow_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    def _frame(self, i: int) -> np.ndarray:
        if i in self._frame_cache:
            self._frame_cache.move_to_end(i)
            return self._frame_cache[i]
        frame = self.source.frame(i)
        self._frame_cache[i] = frame
        if len(self._frame_cache) > self.max_cached_frames:
            self._frame_cache.popitem(last=False)
        return frame

    def _gt_flow(self, t: int, s: int) -> np.ndarray:
        key = (t, s)
        if key in self._flow_cache:
            self._flow_cache.move_to_end(key)
            return self._flow_cache[key]
        flow = self.source.gt_flow(t, s).astype(np.float32)
        self._flow_cache[key] = flow
        if len(self._flow_cache) > self.max_cached_flows:
            self._flow_cache.popitem(last=False)
        return flow

    def _color_jitter(self, imgs: list[np.ndarray]) -> list[np.ndarray]:
        """Shared random gamma/brightness/color across a snippet
        (photometric consistency across frames must be preserved)."""
        gamma = self.rng.uniform(0.8, 1.2)
        bright = self.rng.uniform(0.8, 1.2)
        color = self.rng.uniform(0.9, 1.1, size=3)
        return [
            np.clip((img**gamma) * bright * color, 0.0, 1.0).astype(np.float32)
            for img in imgs
        ]

    def _scale_crop(self, frames, seg, K):
        s = float(self.rng.uniform(1.0, 1.15))
        H, W = frames[0].shape[:2]
        nh, nw = int(np.ceil(H * s)), int(np.ceil(W * s))
        oy = int(self.rng.integers(0, nh - H + 1))
        ox = int(self.rng.integers(0, nw - W + 1))
        return apply_scale_crop(frames, seg, K, s, oy, ox)

    def snippet(self, t: int) -> dict:
        """One snippet centered at t: target + (seq_length-1) sources."""
        k = self.seq_length // 2
        frames = [self._frame(i) for i in range(t - k, t + k + 1)]
        K = np.asarray(self.source.K, np.float32)
        seg = self.source.seg(t).astype(np.int32) if self.with_seg else None
        if self.augment:
            frames = self._color_jitter(frames)
            if self.augment != "color":
                # Zoom+crop is an intrinsics change: consistent for
                # photometric training (K follows), but it makes the
                # GT translation MAGNITUDE unobservable to a net that
                # never sees K — supervised tiers plateau at the zoom
                # ambiguity (measured: pose_sup floor ~0.017 == the
                # 1.0..1.15 zoom range on 0.8 m steps). Pass
                # augment="color" for GT-pose supervision.
                frames, seg, K = self._scale_crop(frames, seg, K)
        target = frames[k]
        sources = np.stack(frames[:k] + frames[k + 1 :], 0)
        out = {
            "target": target,
            "sources": sources,
            "K": K,
        }
        if self.with_seg:
            out["seg"] = seg
        if self.with_gt:
            # Pose of each source relative to target-cam frame: maps
            # target-cam points to source-cam points (warp convention).
            rels = []
            for s in list(range(t - k, t)) + list(range(t + 1, t + k + 1)):
                rels.append(self._warp_pose(t, s))
            out["gt_pose"] = np.stack(rels, 0).astype(np.float32)
        if self.with_flow:
            # Exact target->source flow per source, full-res pixel
            # units (the flownet convention: x_src = x + u; see
            # losses.flow_supervision_loss for the level rescale).
            flows = [
                self._gt_flow(t, s)
                for s in list(range(t - k, t)) + list(range(t + 1, t + k + 1))
            ]
            out["gt_flow"] = np.stack(flows, 0)
        return out

    def _warp_pose(self, target: int, source: int) -> np.ndarray:
        if hasattr(self.source, "warp_pose"):
            return self.source.warp_pose(target, source)
        # Compose from per-step gt_rel (works for both directions).
        # gt_rel(i) maps cam-(i+1) points to cam-i points, so the product
        # over [source, target) is already source<-target (warp convention);
        # for future sources the product is target<-source and needs inverting.
        T = np.eye(4)
        if source < target:
            for i in range(source, target):
                T = T @ self.source.gt_rel(i)
            return T
        for i in range(target, source):
            T = T @ self.source.gt_rel(i)
        return np.linalg.inv(T)

    def batches(self, steps: int | None = None, shuffle: bool = True) -> Iterator[dict]:
        """Yield `steps` batches (or loop indefinitely if None)."""
        if len(self.indices) < self.batch_size:
            return  # sequence too short for even one batch
        produced = 0
        while steps is None or produced < steps:
            order = (
                self.rng.permutation(self.indices)
                if shuffle
                else np.asarray(self.indices)
            )
            for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                chosen = order[start : start + self.batch_size]
                items = [self.snippet(int(t)) for t in chosen]
                yield {
                    key: np.stack([it[key] for it in items], 0)
                    for key in items[0]
                }
                produced += 1
                if steps is not None and produced >= steps:
                    return


class MultiSourceDataset:
    """Shuffled snippet batches drawn across several source sequences.

    Single-scene training overfits texture (measured r1: train-world
    relative-pose error 0.08 m/frame vs 1.08 on an unseen world);
    sampling across worlds is the synthetic analog of the reference's
    multi-sequence KITTI training set (seqs 00-08).
    """

    def __init__(self, sources, batch_size=4, seq_length=3,
                 with_seg=False, with_gt=False, with_flow=False,
                 augment=False, seed=0):
        self.datasets = [
            SnippetDataset(
                s, batch_size=1, seq_length=seq_length, with_seg=with_seg,
                with_gt=with_gt, with_flow=with_flow, augment=augment,
                seed=seed + i,
            )
            for i, s in enumerate(sources)
        ]
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        # Global index: (dataset_idx, target_frame)
        self.index = [
            (d_i, t)
            for d_i, d in enumerate(self.datasets)
            for t in d.indices
        ]

    def batches(self, steps=None, shuffle=True):
        if len(self.index) < self.batch_size:
            return
        produced = 0
        while steps is None or produced < steps:
            order = (
                self.rng.permutation(len(self.index))
                if shuffle
                else np.arange(len(self.index))
            )
            for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                chosen = order[start : start + self.batch_size]
                items = [
                    self.datasets[self.index[i][0]].snippet(self.index[i][1])
                    for i in chosen
                ]
                yield {
                    key: np.stack([it[key] for it in items], 0)
                    for key in items[0]
                }
                produced += 1
                if steps is not None and produced >= steps:
                    return


class ProceduralWorldsDataset:
    """Infinite-worlds snippet batches from a procedural generator.

    The synthetic data engine renders worlds from a seed, so the
    training distribution need never repeat: a pool of live worlds is
    sampled for snippets, and each world is RETIRED after a quota of
    draws and replaced by a freshly-generated one (monotonic seed
    stream). Memorizing textures is impossible — every gradient step
    eventually sees unseen worlds — which separates "can't read
    rotation from images" from "memorized the 16-world training set"
    (the r4 generalization question, R4_RESULTS.md).

    world_factory(seed) -> a frame source (SyntheticSequence,
    DriveSequence, ...). Interface matches MultiSourceDataset:
    `.batches(steps=N)` yields stacked snippet dicts.
    """

    def __init__(self, world_factory, batch_size=4, seq_length=3,
                 with_seg=False, with_gt=False, with_flow=False,
                 augment=False, seed=0,
                 pool_size=8, draws_per_world=None):
        self.factory = world_factory
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.with_seg = with_seg
        self.with_gt = with_gt
        self.with_flow = with_flow
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.pool_size = pool_size
        self.draws_per_world = draws_per_world
        self._next_seed = seed * 100003 + 1
        self._pool: list[SnippetDataset] = []
        self._draws: list[int] = []

    def _fresh(self) -> SnippetDataset:
        s = self._next_seed
        self._next_seed += 1
        return SnippetDataset(
            self.factory(s), batch_size=1, seq_length=self.seq_length,
            with_seg=self.with_seg, with_gt=self.with_gt,
            with_flow=self.with_flow, augment=self.augment, seed=s,
        )

    def _quota(self, ds: SnippetDataset) -> int:
        # Default: one pass over the world's snippets, then retire.
        return self.draws_per_world or max(len(ds.indices), 1)

    def batches(self, steps=None, shuffle=True):
        del shuffle  # always shuffled — the pool IS the shuffle
        while len(self._pool) < self.pool_size:
            self._pool.append(self._fresh())
            self._draws.append(0)
        produced = 0
        while steps is None or produced < steps:
            items = []
            for _ in range(self.batch_size):
                w = int(self.rng.integers(0, len(self._pool)))
                ds = self._pool[w]
                t = ds.indices[
                    int(self.rng.integers(0, len(ds.indices)))
                ]
                items.append(ds.snippet(t))
                self._draws[w] += 1
                if self._draws[w] >= self._quota(ds):
                    self._pool[w] = self._fresh()
                    self._draws[w] = 0
            yield {
                key: np.stack([it[key] for it in items], 0)
                for key in items[0]
            }
            produced += 1
