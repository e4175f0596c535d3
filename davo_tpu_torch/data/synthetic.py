"""Synthetic VO sequences with exact ground truth.

Renders a camera moving through a textured-plane world (fronto-parallel
plane at z = plane_z in world frame). Every quantity the VO stack
consumes — images, depth maps, relative/absolute poses, optical flow,
19-class segmentation labels — is available in closed form, which gives
the integration tests an exact oracle (SURVEY.md §4.3: "tiny synthetic
sequence with exact GT; train tiny nets to overfit; assert ATE -> ~0").

Conventions (shared with davo_tpu_torch.core.warp):
* Camera looks along +z; pixel = K [x/z, y/z, 1].
* `pose(i)` returns C_i = T_{world<-cam_i} (cam-to-world).
* `gt_rel(i)` returns C_i^{-1} C_{i+1} = T_{cam_{i+1} -> cam_i}, i.e.
  the odometry increment such that poses[k+1] = poses[k] @ rel[k]; it
  equals the warp pose for target = frame i+1, source = frame i.

Host-side numpy only (this is a data source, not device compute).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates

NUM_SEG_CLASSES = 19

# Cityscapes train-id convention: classes 11..18 are the dynamic ones
# (person, rider, car, truck, bus, train, motorcycle, bicycle). Dynamic
# billboards draw labels from this set; when a sequence has dynamic
# objects its static background is restricted to labels < 11 so
# `seg >= DYNAMIC_LABEL_START` is an exact dynamic-region mask.
DYNAMIC_LABEL_START = 11


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """Minimal numpy se3 exp (float64) for pose generation."""
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W2
        V = (
            np.eye(3)
            + (1 - np.cos(th)) / th**2 * W
            + (th - np.sin(th)) / th**3 * W2
        )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


class SyntheticSequence:
    """A renderable synthetic odometry sequence with exact GT."""

    def __init__(
        self,
        n_frames: int = 12,
        height: int = 64,
        width: int = 96,
        seed: int = 0,
        plane_z: float = 60.0,
        forward_speed: float = 0.8,
        jitter: float = 0.05,
        rot_jitter: float = 0.004,
        texture_res: int = 1024,
        texture_extent: float = 120.0,
        n_dynamic: int = 0,
        dynamic_speed: float = 0.5,
        trajectory: str = "forward",
        texture_mode: str = "grid",
        loop_radius: float | None = None,
        loop_roll: bool = False,
        dynamic_along_path: bool = False,
        n_static: int = 0,
        rot_amp: float = 0.03,
        rot_period: float = 40.0,
        tilt_amp: float = 0.0,
        tilt_period: float = 25.0,
    ):
        self.n_frames = n_frames
        self.height = height
        self.width = width
        self.plane_z = plane_z
        self.texture_extent = texture_extent
        self.texture_mode = texture_mode
        rng = np.random.default_rng(seed)

        if texture_mode == "grid":
            # Multi-octave smooth texture in [0, 1], rich enough for
            # photometric gradients at several scales.
            # Octave sigmas are chosen >= one pixel footprint on the plane
            # (z/f world-units/px * res/extent texels/world-unit ~ 9 texels)
            # so the point-sampled rendering is alias-free and warps are
            # photometrically reconstructible.
            tex = np.zeros((texture_res, texture_res, 3), np.float32)
            for octave, sigma in ((1.0, 48), (0.5, 16), (0.3, 8)):
                layer = rng.uniform(0, 1, (texture_res, texture_res, 3)).astype(np.float32)
                for c in range(3):
                    layer[..., c] = gaussian_filter(layer[..., c], sigma)
                layer -= layer.min()
                layer /= layer.max() + 1e-6
                tex += octave * layer
            tex /= tex.max()
            self.texture = tex
        else:
            # Procedural sinusoid-field texture: infinite extent (no
            # stored grid), C-inf smooth, alias-controlled by capping
            # the min wavelength at ~3 world units (> 2x the ~1 wu/px
            # footprint at plane_z=60). Enables KITTI-scale (>=900 m)
            # trajectories that a finite texture grid cannot cover.
            assert texture_mode == "procedural", texture_mode
            n_comp = 32
            lam = np.exp(rng.uniform(np.log(3.0), np.log(60.0), n_comp))
            k = 2 * np.pi / lam
            ang = rng.uniform(0, 2 * np.pi, n_comp)
            self._proc_k = np.stack(
                [k * np.cos(ang), k * np.sin(ang)], -1
            )  # (n_comp, 2)
            self._proc_phase = rng.uniform(0, 2 * np.pi, (n_comp, 3))
            amp = np.sqrt(lam)
            self._proc_amp = (amp / amp.sum()).astype(np.float64)
            self.texture = None

        # Static world "semantic" labels: quantize a smoothed scalar
        # field into NUM_SEG_CLASSES regions (stable across views).
        # Region labels as Voronoi cells of random seed points: coherent
        # Cityscapes-like blobs whose scale (~extent/sqrt(n_cells)) is
        # far above the pixel footprint.
        n_cells = 64
        cell_xy = rng.uniform(0, texture_res, (n_cells, 2)).astype(np.float32)
        # With dynamic objects present, background labels stay in the
        # static range so seg >= DYNAMIC_LABEL_START is an exact mask.
        bg_hi = DYNAMIC_LABEL_START if n_dynamic > 0 else NUM_SEG_CLASSES
        cell_label = rng.integers(0, bg_hi, n_cells)
        yy, xx = np.meshgrid(
            np.arange(texture_res, dtype=np.float32),
            np.arange(texture_res, dtype=np.float32),
            indexing="ij",
        )
        best = np.full((texture_res, texture_res), np.inf, np.float32)
        seg = np.zeros((texture_res, texture_res), np.int32)
        for (cx, cy), lab in zip(cell_xy, cell_label):
            d = (xx - cx) ** 2 + (yy - cy) ** 2
            closer = d < best
            best[closer] = d[closer]
            seg[closer] = lab
        self.seg_texture = seg

        # Intrinsics: moderate FoV.
        f = 0.9 * width
        self.K = np.array(
            [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]], np.float64
        )

        if trajectory == "forward":
            # Smooth forward trajectory with lateral/rotational jitter.
            poses = [np.eye(4)]
            for _ in range(n_frames - 1):
                xi = np.concatenate(
                    [
                        rng.normal(0, jitter, 2),  # lateral tx, ty
                        [forward_speed + rng.normal(0, jitter)],  # tz
                        rng.normal(0, rot_jitter, 3),  # rotation
                    ]
                )
                poses.append(poses[-1] @ _se3_exp_np(xi))
        elif trajectory == "wander":
            # Varying-curvature planar path with tangent-tracking roll
            # (+ optional yaw/pitch look-around). The r3 quality ladders
            # proved the "loop" worlds cannot measure rotation learning:
            # their yaw rate is CONSTANT within a world, so a net that
            # regresses the dataset's rotation prior scores the same
            # rot-corr (~0) as one that reads rotation from the images
            # (results_r3_quality3.json; VERDICT r3 missing #1). Here
            # the per-frame rotation VARIES within the world — heading
            # rate omega(t) is a random 3-sinusoid signal of amplitude
            # `rot_amp` rad/frame and period ~`rot_period` frames — so
            # pred-vs-GT per-frame rotation correlation is a falsifiable
            # diagnostic. `tilt_amp` adds sinusoidal yaw/pitch of the
            # view axis away from plane-facing (bounded, keeps the
            # plane in frame), exercising all three rotation axes.
            comps = []
            for frac in (1.0, 0.53, 0.31):
                period = rot_period * frac * rng.uniform(0.8, 1.2)
                comps.append(
                    (2 * np.pi / period, rng.uniform(0, 2 * np.pi),
                     frac)
                )
            t_arr = np.arange(n_frames)
            omega = sum(
                a / sum(c[2] for c in comps) * rot_amp
                * np.sin(w * t_arr + ph)
                for (w, ph, a) in comps
            )
            heading = np.cumsum(omega) - omega[0]
            yaw_t = pitch_t = np.zeros(n_frames)
            if tilt_amp:
                yaw_t = tilt_amp * np.sin(
                    2 * np.pi * t_arr / (tilt_period * rng.uniform(0.8, 1.2))
                    + rng.uniform(0, 2 * np.pi)
                )
                pitch_t = tilt_amp * np.sin(
                    2 * np.pi * t_arr / (tilt_period * rng.uniform(0.6, 1.0))
                    + rng.uniform(0, 2 * np.pi)
                )
            poses = []
            p = np.zeros(2)
            for t in range(n_frames):
                T = np.eye(4)
                c, s = np.cos(heading[t]), np.sin(heading[t])
                roll = np.array(
                    [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
                )
                cy, sy = np.cos(yaw_t[t]), np.sin(yaw_t[t])
                yaw = np.array(
                    [[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]]
                )
                cp, sp = np.cos(pitch_t[t]), np.sin(pitch_t[t])
                pitch = np.array(
                    [[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]]
                )
                T[:3, :3] = roll @ yaw @ pitch
                T[:2, 3] = p
                poses.append(T)
                p = p + forward_speed * np.array(
                    [np.cos(heading[t]), np.sin(heading[t])]
                )
            for t in range(1, n_frames):
                xi = np.concatenate(
                    [rng.normal(0, jitter, 3), rng.normal(0, rot_jitter, 3)]
                )
                poses[t] = poses[t] @ _se3_exp_np(xi)
        else:
            # "loop": a circle in the x-y plane parallel to the textured
            # plane (camera keeps facing it), arc step = forward_speed.
            # Path length n_frames*speed is unbounded by plane distance,
            # which the forward trajectory caps at plane_z — this is the
            # KITTI-scale (100..800 m segment) evaluation world.
            assert trajectory == "loop", trajectory
            r = loop_radius or max(
                n_frames * forward_speed / (2 * np.pi) * 0.6, 30.0
            )
            theta0 = rng.uniform(0, 2 * np.pi)
            poses = []
            for t in range(n_frames):
                th = theta0 + forward_speed * t / r
                T = np.eye(4)
                T[0, 3] = r * (np.cos(th) - np.cos(theta0))
                T[1, 3] = r * (np.sin(th) - np.sin(theta0))
                if loop_roll:
                    # Roll the camera about its view axis so the motion
                    # tangent is always the camera +x axis: in camera
                    # coordinates the motion becomes a near-constant
                    # [speed, ~0, 0] plus a true speed/r rad/frame roll
                    # — the KITTI structure (dominant fixed-axis
                    # translation + small real rotation the net must
                    # read from the flow field), instead of a strafing
                    # translation whose direction rotates through 2*pi
                    # while GT rotation is pure jitter.
                    a = th + np.pi / 2  # tangent of (cos, sin) circle
                    ca, sa = np.cos(a), np.sin(a)
                    T[:3, :3] = np.array(
                        [[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]]
                    )
                poses.append(T)
            for t in range(1, n_frames):
                xi = np.concatenate(
                    [rng.normal(0, jitter, 3), rng.normal(0, rot_jitter, 3)]
                )
                poses[t] = poses[t] @ _se3_exp_np(xi)
        self.poses = np.stack(poses)  # (N, 4, 4) cam-to-world

        # Independently-moving textured billboards (the dynamic scene
        # content the paper's attention is FOR). Fronto-parallel rects
        # at fixed z between the camera path and the background plane,
        # constant world velocity, exact GT depth/seg/flow via depth
        # compositing. Drawn AFTER every static-world RNG draw so
        # n_dynamic=0 sequences are bit-identical to r1.
        self.objects: list[dict] = []
        if n_dynamic:
            cam_end_z = float(self.poses[:, 2, 3].max()) + 1.0
            for _ in range(n_dynamic):
                z = rng.uniform(
                    cam_end_z + 0.35 * (plane_z - cam_end_z),
                    cam_end_z + 0.85 * (plane_z - cam_end_z),
                )
                w_obj = rng.uniform(0.18, 0.30) * z
                h_obj = 0.75 * w_obj
                half_w = z * (width / 2) / self.K[0, 0]
                half_h = z * (height / 2) / self.K[1, 1]
                center = np.array(
                    [
                        rng.uniform(-0.55, 0.55) * half_w,
                        rng.uniform(-0.55, 0.55) * half_h,
                    ]
                )
                ang = rng.uniform(0, 2 * np.pi)
                vel = dynamic_speed * np.array(
                    [np.cos(ang), 0.35 * np.sin(ang)]
                )
                label = int(
                    rng.integers(DYNAMIC_LABEL_START, NUM_SEG_CLASSES)
                )
                otex = np.zeros((64, 64, 3), np.float32)
                for octave, sigma in ((1.0, 8.0), (0.6, 3.0)):
                    layer = rng.uniform(0, 1, (64, 64, 3)).astype(
                        np.float32
                    )
                    for c in range(3):
                        layer[..., c] = gaussian_filter(layer[..., c], sigma)
                    layer -= layer.min()
                    layer /= layer.max() + 1e-6
                    otex += octave * layer
                otex /= otex.max()
                if dynamic_along_path:
                    # Re-anchor to a random frame's view so coverage
                    # persists over LONG sequences (start-frustum
                    # placement decays to 0 % past ~frame 50 on loop
                    # worlds). Drawn after all start-anchored draws so
                    # dynamic_along_path=False stays bit-identical.
                    f = int(rng.integers(0, n_frames))
                    Cf = self.poses[f]
                    o = Cf[:3, 3]
                    axis = Cf[:3, :3] @ np.array([0.0, 0.0, 1.0])
                    z = o[2] + rng.uniform(0.35, 0.85) * (plane_z - o[2])
                    dist = z - o[2]
                    look = o[:2] + (dist / axis[2]) * axis[:2]
                    half_w = dist * (width / 2) / self.K[0, 0]
                    half_h = dist * (height / 2) / self.K[1, 1]
                    center = (
                        look
                        + np.array(
                            [
                                rng.uniform(-0.55, 0.55) * half_w,
                                rng.uniform(-0.55, 0.55) * half_h,
                            ]
                        )
                        - vel * f
                    )
                    w_obj = rng.uniform(0.18, 0.30) * dist
                    h_obj = 0.75 * w_obj
                self.objects.append(
                    dict(z=z, w=w_obj, h=h_obj, center=center, vel=vel,
                         label=label, tex=otex)
                )

        # STATIC depth structure (r3): fixed textured billboards at
        # varying depths between the camera path and the background
        # plane. A single-plane world makes yaw visually near-
        # unidentifiable (planar rotation/translation ambiguity at
        # narrow FOV) — the r3 ladder measured the pose net regressing
        # the dataset's rotation PRIOR (pred/GT rotation correlation
        # -0.02 at any resolution/capacity/steps). Parallax between
        # depth layers is what makes rotation observable. Anchored to
        # random frames' frusta (coverage persists over long loops);
        # labels stay in the static range so attention treats them as
        # scene, not movers. Drawn AFTER every existing draw so
        # n_static=0 sequences remain bit-identical.
        if n_static:
            for _ in range(n_static):
                f = int(rng.integers(0, n_frames))
                Cf = self.poses[f]
                o = Cf[:3, 3]
                axis = Cf[:3, :3] @ np.array([0.0, 0.0, 1.0])
                dist = max(
                    rng.uniform(0.25, 0.8) * (plane_z - o[2]), 1.0
                )
                z_obj = o[2] + dist
                look = o[:2] + (dist / max(axis[2], 1e-6)) * axis[:2]
                half_w = dist * (width / 2) / self.K[0, 0]
                half_h = dist * (height / 2) / self.K[1, 1]
                center = look + np.array(
                    [
                        rng.uniform(-0.7, 0.7) * half_w,
                        rng.uniform(-0.7, 0.7) * half_h,
                    ]
                )
                w_obj = rng.uniform(0.15, 0.35) * dist
                h_obj = rng.uniform(0.5, 1.2) * w_obj
                # Always below DYNAMIC_LABEL_START: the "seg >= start
                # <=> mover" invariant must hold with movers present.
                label = int(rng.integers(0, DYNAMIC_LABEL_START))
                otex = np.zeros((64, 64, 3), np.float32)
                for octave, sigma in ((1.0, 8.0), (0.6, 3.0)):
                    layer = rng.uniform(0, 1, (64, 64, 3)).astype(
                        np.float32
                    )
                    for c in range(3):
                        layer[..., c] = gaussian_filter(
                            layer[..., c], sigma
                        )
                    layer -= layer.min()
                    layer /= layer.max() + 1e-6
                    otex += octave * layer
                otex /= otex.max()
                self.objects.append(
                    dict(
                        z=z_obj, w=w_obj, h=h_obj, center=center,
                        vel=np.zeros(2), label=label, tex=otex,
                    )
                )

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.n_frames

    def pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def gt_rel(self, i: int) -> np.ndarray:
        """C_i^{-1} C_{i+1}: odometry increment frame i -> i+1."""
        return np.linalg.inv(self.poses[i]) @ self.poses[i + 1]

    def warp_pose(self, target: int, source: int) -> np.ndarray:
        """T mapping target-cam points to source-cam points."""
        return np.linalg.inv(self.poses[source]) @ self.poses[target]

    # ------------------------------------------------------------------
    def _rays(self) -> np.ndarray:
        """(3, H, W) unit-z camera rays K^-1 [u, v, 1]."""
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        pix = np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1).astype(np.float64)
        rays = np.linalg.inv(self.K) @ pix
        return rays.reshape(3, self.height, self.width)

    def _plane_hits(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """World xy hit coords + camera depth for every pixel of frame i."""
        C = self.poses[i]
        rays = self._rays()
        d_w = np.einsum("ij,jhw->ihw", C[:3, :3], rays)
        o = C[:3, 3]
        tstar = (self.plane_z - o[2]) / d_w[2]
        px = o[0] + tstar * d_w[0]
        py = o[1] + tstar * d_w[1]
        return px, py, tstar  # depth in cam frame == tstar (rays have z=1)

    def _tex_coords(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        # Procedural worlds have no image texture grid; the label grid
        # shares the same resolution convention.
        res = (
            self.texture if self.texture is not None else self.seg_texture
        ).shape[0]
        half = self.texture_extent / 2
        tx = (px + half) / self.texture_extent * (res - 1)
        ty = (py + half) / self.texture_extent * (res - 1)
        return np.stack([ty, tx])

    def _object_center(self, obj: dict, i: int) -> np.ndarray:
        return obj["center"] + obj["vel"] * i

    def _surfaces(self, i: int):
        """Per-pixel nearest surface of frame i via depth compositing.

        Returns (surf, depth, px, py, lx, ly): surf is -1 for the
        background plane or the index into `self.objects`; (px, py) are
        background-plane world hits; (lx, ly) are in-object normalized
        coords [0, 1] where surf >= 0.
        """
        C = self.poses[i]
        rays = self._rays()
        d_w = np.einsum("ij,jhw->ihw", C[:3, :3], rays)
        o = C[:3, 3]
        t_bg = (self.plane_z - o[2]) / d_w[2]
        px = o[0] + t_bg * d_w[0]
        py = o[1] + t_bg * d_w[1]
        depth = t_bg.copy()
        surf = np.full(depth.shape, -1, np.int32)
        lx_all = np.zeros_like(depth)
        ly_all = np.zeros_like(depth)
        for k, obj in enumerate(self.objects):
            t_k = (obj["z"] - o[2]) / d_w[2]
            hx = o[0] + t_k * d_w[0]
            hy = o[1] + t_k * d_w[1]
            cx, cy = self._object_center(obj, i)
            lx = (hx - cx) / obj["w"] + 0.5
            ly = (hy - cy) / obj["h"] + 0.5
            inside = (
                (t_k > 0.1)
                & (lx >= 0) & (lx <= 1)
                & (ly >= 0) & (ly <= 1)
                & (t_k < depth)
            )
            depth[inside] = t_k[inside]
            surf[inside] = k
            lx_all[inside] = lx[inside]
            ly_all[inside] = ly[inside]
        return surf, depth, px, py, lx_all, ly_all

    def _sample_background(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        if self.texture_mode == "procedural":
            arg = (
                px[..., None] * self._proc_k[:, 0]
                + py[..., None] * self._proc_k[:, 1]
            )  # (H, W, n_comp)
            # sin(arg + phase_nc) expanded by the angle-addition
            # identity: one sin+cos of the (H,W,n) field plus per-
            # channel matvecs, instead of a (H,W,n,3) f64 intermediate
            # (163 MB, 15M sins — measured 560 ms/frame -> ~20 ms).
            # Bit-identical math in f64 up to rounding.
            sin_a, cos_a = np.sin(arg), np.cos(arg)
            w_sin = self._proc_amp[:, None] * np.cos(self._proc_phase)
            w_cos = self._proc_amp[:, None] * np.sin(self._proc_phase)
            out = 0.5 + 1.6 * (sin_a @ w_sin + cos_a @ w_cos)
            return np.clip(out, 0.0, 1.0).astype(np.float32)
        coords = self._tex_coords(px, py)
        return np.stack(
            [
                map_coordinates(self.texture[..., c], coords, order=1, mode="nearest")
                for c in range(3)
            ],
            axis=-1,
        )

    def frame(self, i: int) -> np.ndarray:
        """(H, W, 3) float32 image in [0, 1]."""
        surf, _, px, py, lx, ly = self._surfaces(i)
        out = self._sample_background(px, py)
        for k, obj in enumerate(self.objects):
            m = surf == k
            if not m.any():
                continue
            res = obj["tex"].shape[0]
            oc = np.stack([ly[m] * (res - 1), lx[m] * (res - 1)])
            for c in range(3):
                out[..., c][m] = map_coordinates(
                    obj["tex"][..., c], oc, order=1, mode="nearest"
                )
        return out.astype(np.float32)

    def depth(self, i: int) -> np.ndarray:
        """(H, W) float32 camera-frame depth of frame i (composited)."""
        _, depth, *_ = self._surfaces(i)
        return depth.astype(np.float32)

    def seg(self, i: int) -> np.ndarray:
        """(H, W) int32 labels in [0, NUM_SEG_CLASSES)."""
        surf, _, px, py, _, _ = self._surfaces(i)
        coords = self._tex_coords(px, py)
        # Procedural worlds are unbounded: tile the label field.
        mode = "grid-wrap" if self.texture_mode == "procedural" else "nearest"
        out = map_coordinates(
            self.seg_texture, coords, order=0, mode=mode
        ).astype(np.int32)
        for k, obj in enumerate(self.objects):
            out[surf == k] = obj["label"]
        return out

    def dynamic_mask(self, i: int) -> np.ndarray:
        """(H, W) bool: pixels on independently-moving objects."""
        return self.seg(i) >= DYNAMIC_LABEL_START if self.objects else (
            np.zeros((self.height, self.width), bool)
        )

    def gt_flow(self, i: int, j: int) -> np.ndarray:
        """(H, W, 2) exact optical flow from frame i to frame j (du, dv).

        Dynamic-object pixels carry the object's own world motion on
        top of ego-motion — the flow is of the SCENE, not of the
        camera, which is exactly the cue the attention net consumes.
        """
        surf, _, px, py, lx, ly = self._surfaces(i)
        pxj = px.copy()
        pyj = py.copy()
        pz = np.full_like(px, self.plane_z)
        for k, obj in enumerate(self.objects):
            m = surf == k
            if not m.any():
                continue
            cx_i, cy_i = self._object_center(obj, i)
            disp = obj["vel"] * (j - i)
            pxj[m] = cx_i + (lx[m] - 0.5) * obj["w"] + disp[0]
            pyj[m] = cy_i + (ly[m] - 0.5) * obj["h"] + disp[1]
            pz[m] = obj["z"]
        p_w = np.stack([pxj, pyj, pz], 0)
        Cj_inv = np.linalg.inv(self.poses[j])
        p_c = np.einsum("ij,jhw->ihw", Cj_inv[:3, :3], p_w) + Cj_inv[:3, 3][:, None, None]
        proj = np.einsum("ij,jhw->ihw", self.K, p_c)
        u2 = proj[0] / proj[2]
        v2 = proj[1] / proj[2]
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        return np.stack([u2 - u, v2 - v], axis=-1).astype(np.float32)


class DriveSequence:
    """Forward-looking KITTI-like world: ground plane + sky + upright
    billboards, yaw-heading trajectory. Exact GT for every quantity.

    The plane worlds (SyntheticSequence) view a fronto-parallel wall:
    depth is near-constant, yaw is entangled with lateral translation
    (narrow-FOV planar ambiguity), and forward motion is capped by the
    wall. This world is the reference's actual regime (SURVEY §3.1,
    KITTI odometry): the camera drives along a varying-yaw path on a
    textured ground plane with upright textured billboards at real
    depth range, plus a direction-only procedural sky (photometric
    signal that moves ONLY with rotation). Conventions:

    * camera x right, y DOWN, z forward; ground at world y = +cam_h;
      heading = rotation about y; pose(i) = cam-to-world like
      SyntheticSequence (gt_rel / warp_pose contracts identical).
    * ground texture: procedural sinusoid field over world (x, z) with
      per-component footprint attenuation (grazing-angle anti-alias);
      sky: same field over (azimuth, elevation) * sky_scale at
      depth = far_z.
    * seg: ground labels = Voronoi cells over (x, z); sky = class 10
      (the Cityscapes train-id for sky); billboards carry their own
      labels (movers >= DYNAMIC_LABEL_START, statics below).
    """

    def __init__(
        self,
        n_frames: int = 12,
        height: int = 64,
        width: int = 96,
        seed: int = 0,
        cam_height: float = 1.6,
        forward_speed: float = 0.8,
        jitter: float = 0.02,
        rot_jitter: float = 0.002,
        yaw_amp: float = 0.02,
        yaw_period: float = 60.0,
        pitch_amp: float = 0.004,
        n_static: int = 12,
        n_dynamic: int = 0,
        dynamic_speed: float = 0.3,
        far_z: float = 300.0,
        texture_extent: float = 120.0,
        sky_scale: float = 60.0,
    ):
        self.n_frames = n_frames
        self.height = height
        self.width = width
        self.cam_height = cam_height
        self.far_z = far_z
        self.texture_extent = texture_extent
        self.sky_scale = sky_scale
        rng = np.random.default_rng(seed)

        # Procedural texture components (shared by ground and sky).
        n_comp = 32
        lam = np.exp(rng.uniform(np.log(1.5), np.log(60.0), n_comp))
        k = 2 * np.pi / lam
        ang = rng.uniform(0, 2 * np.pi, n_comp)
        self._proc_k = np.stack([k * np.cos(ang), k * np.sin(ang)], -1)
        self._proc_phase = rng.uniform(0, 2 * np.pi, (n_comp, 3))
        amp = np.sqrt(lam)
        self._proc_amp = (amp / amp.sum()).astype(np.float64)

        # Ground semantic labels: Voronoi cells over (x, z), tiled.
        res = 512
        n_cells = 64
        cell_xy = rng.uniform(0, res, (n_cells, 2)).astype(np.float32)
        bg_hi = DYNAMIC_LABEL_START  # ground labels stay static-range
        cell_label = rng.integers(0, bg_hi, n_cells)
        cell_label[cell_label == 10] = 9  # 10 is reserved for sky
        yy, xx = np.meshgrid(
            np.arange(res, dtype=np.float32),
            np.arange(res, dtype=np.float32),
            indexing="ij",
        )
        best = np.full((res, res), np.inf, np.float32)
        seg = np.zeros((res, res), np.int32)
        for (cx, cy), lab in zip(cell_xy, cell_label):
            d = (xx - cx) ** 2 + (yy - cy) ** 2
            closer = d < best
            best[closer] = d[closer]
            seg[closer] = lab
        self.seg_texture = seg
        self.sky_label = 10

        f = 0.9 * width
        self.K = np.array(
            [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]],
            np.float64,
        )

        # Heading: varying yaw rate (3-sinusoid, like wander), camera
        # tangent-tracking via Ry(psi); small sinusoidal pitch wobble.
        comps = []
        for frac in (1.0, 0.53, 0.31):
            period = yaw_period * frac * rng.uniform(0.8, 1.2)
            comps.append(
                (2 * np.pi / period, rng.uniform(0, 2 * np.pi), frac)
            )
        t_arr = np.arange(n_frames)
        wsum = sum(c[2] for c in comps)
        omega = sum(
            a / wsum * yaw_amp * np.sin(w * t_arr + ph)
            for (w, ph, a) in comps
        )
        psi = np.cumsum(omega) - omega[0]
        pitch = pitch_amp * np.sin(
            2 * np.pi * t_arr / (yaw_period * 0.4 * rng.uniform(0.8, 1.2))
            + rng.uniform(0, 2 * np.pi)
        )
        poses = []
        p = np.zeros(3)
        for t in range(n_frames):
            c, s = np.cos(psi[t]), np.sin(psi[t])
            Ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
            cp, sp = np.cos(pitch[t]), np.sin(pitch[t])
            Rx = np.array([[1.0, 0, 0], [0, cp, -sp], [0, sp, cp]])
            T = np.eye(4)
            T[:3, :3] = Ry @ Rx
            T[:3, 3] = p
            poses.append(T)
            p = p + forward_speed * np.array(
                [np.sin(psi[t]), 0.0, np.cos(psi[t])]
            )
        for t in range(1, n_frames):
            xi = np.concatenate(
                [rng.normal(0, jitter, 3), rng.normal(0, rot_jitter, 3)]
            )
            poses[t] = poses[t] @ _se3_exp_np(xi)
        self.poses = np.stack(poses)

        # Upright billboards along the path: center/edge basis stored
        # as general plane rects (c, e1 horizontal, e2 = world -y up
        # handled via +y down extents).
        self.objects: list[dict] = []
        for is_dyn in [False] * n_static + [True] * n_dynamic:
            fidx = int(rng.integers(0, n_frames))
            o = self.poses[fidx][:3, 3]
            ps = psi[fidx]
            fwd = np.array([np.sin(ps), 0.0, np.cos(ps)])
            lat = np.array([np.cos(ps), 0.0, -np.sin(ps)])
            dist = rng.uniform(8.0, 80.0)
            lateral = rng.uniform(2.0, 14.0) * rng.choice([-1.0, 1.0])
            if is_dyn:
                lateral = rng.uniform(-3.0, 3.0)
            w_obj = rng.uniform(1.5, 6.0)
            h_obj = rng.uniform(1.5, 5.0)
            c = (
                o
                + dist * fwd
                + lateral * lat
                + np.array([0.0, cam_height - h_obj / 2, 0.0])
            )
            normal = -fwd  # faces back along the local heading
            e1 = lat
            e2 = np.array([0.0, 1.0, 0.0])  # y down: ly grows downward
            vel = np.zeros(3)
            label = int(rng.integers(0, DYNAMIC_LABEL_START))
            if label == 10:
                label = 9
            if is_dyn:
                vel = dynamic_speed * (
                    fwd * rng.uniform(-1.0, 1.0)
                    + lat * rng.uniform(-0.3, 0.3)
                )
                label = int(
                    rng.integers(DYNAMIC_LABEL_START, NUM_SEG_CLASSES)
                )
            otex = np.zeros((64, 64, 3), np.float32)
            for octave, sigma in ((1.0, 8.0), (0.6, 3.0)):
                layer = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
                for ch in range(3):
                    layer[..., ch] = gaussian_filter(layer[..., ch], sigma)
                layer -= layer.min()
                layer /= layer.max() + 1e-6
                otex += octave * layer
            otex /= otex.max()
            self.objects.append(
                dict(c=c, n=normal, e1=e1, e2=e2, w=w_obj, h=h_obj,
                     vel=vel, label=label, tex=otex)
            )

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.n_frames

    def pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def gt_rel(self, i: int) -> np.ndarray:
        return np.linalg.inv(self.poses[i]) @ self.poses[i + 1]

    def warp_pose(self, target: int, source: int) -> np.ndarray:
        return np.linalg.inv(self.poses[source]) @ self.poses[target]

    def _rays(self) -> np.ndarray:
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        pix = np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1)
        rays = np.linalg.inv(self.K) @ pix.astype(np.float64)
        return rays.reshape(3, self.height, self.width)

    def _surfaces(self, i: int):
        """Per-pixel nearest surface: returns (surf, depth, point_w,
        fp, sky). surf: -2 sky, -1 ground, >=0 object index; depth is
        camera-frame z (rays have unit z); point_w: (3, H, W) world
        hit points (sky rows hold o + far_z*d); fp: texture footprint
        in world units (ground anti-alias); sky: bool mask."""
        C = self.poses[i]
        rays = self._rays()
        d_w = np.einsum("ij,jhw->ihw", C[:3, :3], rays)
        o = C[:3, 3]
        dy = d_w[1]
        eps = 1e-6
        t_g = np.where(
            dy > eps, (self.cam_height - o[1]) / np.where(dy > eps, dy, 1.0),
            np.inf,
        )
        sky = ~np.isfinite(t_g) | (t_g > self.far_z) | (t_g <= 0)
        depth = np.where(sky, self.far_z, t_g)
        surf = np.where(sky, -2, -1).astype(np.int32)
        point = o[:, None, None] + depth[None] * d_w
        # Ground texture footprint: horizontal ~ t/fx; along-depth
        # ~ t^2 * |dy| / (fx * h) is the classic t^2/(f h) growth.
        fx = self.K[0, 0]
        h_above = max(self.cam_height - float(o[1]), 0.05)
        fp = np.maximum(depth / fx, depth * depth / (fx * h_above) * 0.5)
        lx_all = np.zeros_like(depth)
        ly_all = np.zeros_like(depth)
        for k, obj in enumerate(self.objects):
            c = obj["c"] + obj["vel"] * i
            denom = np.einsum("j,jhw->hw", obj["n"], d_w)
            denom = np.where(np.abs(denom) < eps, eps, denom)
            t_k = (obj["n"] @ (c - o)) / denom
            hit = o[:, None, None] + t_k[None] * d_w - c[:, None, None]
            lx = np.einsum("j,jhw->hw", obj["e1"], hit) / obj["w"] + 0.5
            ly = np.einsum("j,jhw->hw", obj["e2"], hit) / obj["h"] + 0.5
            inside = (
                (t_k > 0.5)
                & (lx >= 0) & (lx <= 1)
                & (ly >= 0) & (ly <= 1)
                & (t_k < depth)
            )
            depth = np.where(inside, t_k, depth)
            surf = np.where(inside, k, surf)
            lx_all = np.where(inside, lx, lx_all)
            ly_all = np.where(inside, ly, ly_all)
            pt = o[:, None, None] + t_k[None] * d_w
            point = np.where(inside[None], pt, point)
        return surf, depth, point, fp, d_w

    def _proc_sample(self, a: np.ndarray, b: np.ndarray,
                     fp: np.ndarray | None = None) -> np.ndarray:
        """Procedural RGB at 2-D coords (a, b), with optional
        per-pixel footprint attenuation per frequency component."""
        arg = (
            a[..., None] * self._proc_k[:, 0]
            + b[..., None] * self._proc_k[:, 1]
        )
        amp = self._proc_amp[None, None]
        if fp is not None:
            kmag = np.linalg.norm(self._proc_k, axis=-1)
            att = np.exp(-0.5 * (kmag[None, None] * fp[..., None]) ** 2)
            amp = amp * att
        sin_a, cos_a = np.sin(arg), np.cos(arg)
        w_sin = np.cos(self._proc_phase)
        w_cos = np.sin(self._proc_phase)
        out = 0.5 + 1.6 * (
            (sin_a * amp) @ w_sin + (cos_a * amp) @ w_cos
        )
        return np.clip(out, 0.0, 1.0).astype(np.float32)

    def frame(self, i: int) -> np.ndarray:
        surf, _, point, fp, d_w = self._surfaces(i)
        # Ground
        out = self._proc_sample(point[0], point[2], fp)
        # Sky: direction-only field (moves with rotation only).
        d_norm = d_w / np.linalg.norm(d_w, axis=0, keepdims=True)
        az = np.arctan2(d_norm[0], d_norm[2]) * self.sky_scale
        el = np.arcsin(np.clip(-d_norm[1], -1, 1)) * self.sky_scale
        sky_img = self._proc_sample(az, el)
        m_sky = surf == -2
        out[m_sky] = 0.35 * sky_img[m_sky] + np.array(
            [0.35, 0.42, 0.5], np.float32
        )
        out = np.clip(out, 0.0, 1.0)
        for k, obj in enumerate(self.objects):
            m = surf == k
            if not m.any():
                continue
            res = obj["tex"].shape[0]
            # reuse lx/ly via recompute (kept out of _surfaces return
            # for interface compactness)
            c = obj["c"] + obj["vel"] * i
            C = self.poses[i]
            o = C[:3, 3]
            denom = np.einsum("j,jhw->hw", obj["n"], d_w)
            denom = np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            t_k = (obj["n"] @ (c - o)) / denom
            hit = o[:, None, None] + t_k[None] * d_w - c[:, None, None]
            lx = np.einsum("j,jhw->hw", obj["e1"], hit) / obj["w"] + 0.5
            ly = np.einsum("j,jhw->hw", obj["e2"], hit) / obj["h"] + 0.5
            oc = np.stack(
                [np.clip(ly[m], 0, 1) * (res - 1),
                 np.clip(lx[m], 0, 1) * (res - 1)]
            )
            for ch in range(3):
                out[..., ch][m] = map_coordinates(
                    obj["tex"][..., ch], oc, order=1, mode="nearest"
                )
        return out.astype(np.float32)

    def depth(self, i: int) -> np.ndarray:
        _, depth, *_ = self._surfaces(i)
        return depth.astype(np.float32)

    def seg(self, i: int) -> np.ndarray:
        surf, _, point, _, _ = self._surfaces(i)
        res = self.seg_texture.shape[0]
        half = self.texture_extent / 2
        tx = (point[0] + half) / self.texture_extent * (res - 1)
        tz = (point[2] + half) / self.texture_extent * (res - 1)
        out = map_coordinates(
            self.seg_texture, np.stack([tz, tx]), order=0,
            mode="grid-wrap",
        ).astype(np.int32)
        out[surf == -2] = self.sky_label
        for k, obj in enumerate(self.objects):
            out[surf == k] = obj["label"]
        return out

    def dynamic_mask(self, i: int) -> np.ndarray:
        return self.seg(i) >= DYNAMIC_LABEL_START

    def gt_flow(self, i: int, j: int) -> np.ndarray:
        surf, _, point, _, _ = self._surfaces(i)
        p_w = point.copy()
        for k, obj in enumerate(self.objects):
            m = surf == k
            if m.any() and np.any(obj["vel"]):
                disp = obj["vel"] * (j - i)
                for ax in range(3):
                    p_w[ax][m] += disp[ax]
        Cj_inv = np.linalg.inv(self.poses[j])
        p_c = (
            np.einsum("ij,jhw->ihw", Cj_inv[:3, :3], p_w)
            + Cj_inv[:3, 3][:, None, None]
        )
        proj = np.einsum("ij,jhw->ihw", self.K, p_c)
        u2 = proj[0] / proj[2]
        v2 = proj[1] / proj[2]
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        return np.stack([u2 - u, v2 - v], axis=-1).astype(np.float32)
