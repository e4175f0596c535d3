"""SE(3)/SO(3) geometry, camera models and trajectory algebra (port of
davo_tpu.core.geometry).

The 6-vector convention is the reference's ``[tx, ty, tz, rx, ry, rz]``
with Euler angles and R = Rz @ Ry @ Rx; the BA backend gets the Lie
exp/log (axis-angle) besides. All functions broadcast over leading
batch dimensions and run in the input's dtype (float32 here), with no
data-dependent branch: the Taylor guards select with `torch.where`, so
`torch.func.jacfwd` and `vmap` trace them as the reference's `jnp.where`.
"""

from __future__ import annotations

import torch

from davo_tpu_torch import exact_f32

_EPS = 1e-8


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with JAX's gradient: at an exact tie with a bound half
    the gradient passes (JAX's max/min split ties evenly; `torch.clamp`
    passes all of it). Use wherever the reference clips a value that
    carries a gradient."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def euler_to_mat(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles ``[rx, ry, rz]`` (radians) -> rotation (..., 3, 3),
    R = Rz(rz) @ Ry(ry) @ Rx(rx) in closed form."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def mat_to_euler(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> Euler ``[rx, ry, rz]`` (R = Rz Ry Rx),
    gimbal-safe by clipping; valid for |ry| < pi/2."""
    sy = clip(-rot[..., 2, 0], -1.0 + 1e-7, 1.0 - 1e-7)
    ry = torch.asin(sy)
    rx = torch.atan2(rot[..., 2, 1], rot[..., 2, 2])
    rz = torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    return torch.stack([rx, ry, rz], -1)


def pose_vec_to_mat(vec: torch.Tensor, rotation: str = "euler") -> torch.Tensor:
    """6-DoF ``[tx, ty, tz, r...]`` -> homogeneous (..., 4, 4); `rotation`
    is "euler" (the reference's layout) or "axis_angle" (Lie, BA)."""
    if rotation == "euler":
        rot = euler_to_mat(vec[..., 3:6])
    elif rotation == "axis_angle":
        rot = so3_exp(vec[..., 3:6])
    else:
        raise ValueError(f"unknown rotation parameterization: {rotation}")
    return rt_to_mat(rot, vec[..., :3])


def mat_to_pose_vec(mat: torch.Tensor, rotation: str = "euler") -> torch.Tensor:
    """Homogeneous (..., 4, 4) -> ``[tx, ty, tz, r...]`` (inverse of above)."""
    rot = mat[..., :3, :3]
    if rotation == "euler":
        r = mat_to_euler(rot)
    elif rotation == "axis_angle":
        r = so3_log(rot)
    else:
        raise ValueError(f"unknown rotation parameterization: {rotation}")
    return torch.cat([mat[..., :3, 3], r], -1)


def rt_to_mat(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], -1)
    # The [0, 0, 0, 1] row made on the tensors' device: a constant from
    # the host would be a host-to-device copy in every call.
    zero = torch.zeros_like(t[..., :1])
    bottom = torch.cat([zero, zero, zero, torch.ones_like(zero)], -1)[..., None, :]
    return torch.cat([top, bottom], -2)


# ---------------------------------------------------------------------------
# SO(3) Lie group
# ---------------------------------------------------------------------------


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [[zero, -wz, wy], [wz, zero, -wx], [-wy, wx, zero]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


# Taylor guards: below theta = 0.1 the series is exact to float32, where
# the closed forms cancel ((1 - cos t) loses half the mantissa below
# t ~ 1e-2). The double `where` keeps tangents finite at theta = 0.
_SMALL_SQ = 1e-2


def _safe_theta(theta_sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    small = theta_sq < _SMALL_SQ
    return small, torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))


def _sinc(theta_sq: torch.Tensor) -> torch.Tensor:
    """sin(t)/t, t = sqrt(theta_sq)."""
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0
    return torch.where(small, taylor, torch.sin(theta) / theta)


def _cosc(theta_sq: torch.Tensor) -> torch.Tensor:
    """(1 - cos t)/t^2 as 2 sin^2(t/2)/t^2 (no cancellation)."""
    small, theta = _safe_theta(theta_sq)
    taylor = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    half_sinc = torch.sin(0.5 * theta) / theta
    return torch.where(small, taylor, 2.0 * half_sinc * half_sinc)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (Rodrigues)."""
    exact_f32()
    theta_sq = (w * w).sum(-1)[..., None, None]
    W = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + _sinc(theta_sq) * W + _cosc(theta_sq) * (W @ W)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (..., 3), principal branch |w| <= pi.

    theta by atan2 of the sine (from vee(R - R^T)) and the cosine (from
    the trace), well conditioned near 0 where arccos loses half the
    digits; near pi the axis comes from the diagonal, signed by the
    off-diagonal sums against its largest component (Shepperd).
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = clip((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = so3_vee(rot - rot.transpose(-1, -2))
    # d|v|/dv is NaN at v = 0 (the identity, which pose-graph edges that
    # agree exactly reach); the double `where` keeps value and tangent finite.
    nsq = (vee * vee).sum(-1)
    tiny = nsq < 1e-24
    one = torch.ones_like(nsq)
    sin_theta = torch.where(tiny, 0.0 * one, 0.5 * torch.sqrt(torch.where(tiny, one, nsq)))
    theta = torch.atan2(sin_theta, cos_theta)
    th = theta[..., None]
    scale = torch.where(
        th < 1e-4,
        0.5 + th**2 / 12.0,  # Taylor of theta / (2 sin theta)
        th / (2.0 * sin_theta[..., None] + _EPS),
    )
    w_generic = scale * vee
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], -1)
    axis_sq = (diag + 1.0) * 0.5
    axis_sq = torch.maximum(axis_sq, torch.zeros_like(axis_sq))  # jnp.maximum's tie gradient
    axis = torch.sqrt(axis_sq + _EPS)
    s_xy = rot[..., 0, 1] + rot[..., 1, 0]
    s_xz = rot[..., 0, 2] + rot[..., 2, 0]
    s_yz = rot[..., 1, 2] + rot[..., 2, 1]

    def sgn(x):
        one = torch.ones_like(x)
        return torch.where(x >= 0, one, -one)

    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    cand_x = torch.stack([ax, sgn(s_xy) * ay, sgn(s_xz) * az], -1)
    cand_y = torch.stack([sgn(s_xy) * ax, ay, sgn(s_yz) * az], -1)
    cand_z = torch.stack([sgn(s_xz) * ax, sgn(s_yz) * ay, az], -1)
    ref = torch.argmax(axis_sq, -1)[..., None]
    axis = torch.where(ref == 0, cand_x, torch.where(ref == 1, cand_y, cand_z))
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    near_pi = (torch.pi - theta)[..., None] < 1e-4
    return torch.where(near_pi, axis * th, w_generic)


# ---------------------------------------------------------------------------
# SE(3) Lie group
# ---------------------------------------------------------------------------


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist ``[v(3), w(3)]`` -> 4x4 transform (exact left Jacobian)."""
    exact_f32()
    v, w = xi[..., :3], xi[..., 3:6]
    theta_sq = (w * w).sum(-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    rot = eye + _sinc(theta_sq) * W + _cosc(theta_sq) * W2
    # V = I + (1-cos)/t^2 W + (t - sin t)/t^3 W^2, the last by Taylor
    # below t = 0.1 where t - sin t cancels.
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    c2 = torch.where(
        small, taylor, (theta - torch.sin(theta)) / torch.where(small, torch.ones_like(theta), theta_sq * theta)
    )
    V = eye + _cosc(theta_sq) * W + c2 * W2
    return rt_to_mat(rot, torch.einsum("...ij,...j->...i", V, v))


def se3_log(mat: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> twist ``[v, w]`` (inverse of `se3_exp`)."""
    exact_f32()
    w = so3_log(mat[..., :3, :3])
    theta_sq = (w * w).sum(-1)[..., None, None]
    W = so3_hat(w)
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device)
    # V^-1 = I - W/2 + coef W^2, coef = (1 - (t/2) cot(t/2)) / t^2 (the cot
    # form avoids 1 - cos; Taylor below t = 0.1).
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0
    half = 0.5 * theta
    one = torch.ones_like(theta)
    cot_term = half * torch.cos(half) / torch.where(small, one, torch.sin(half))
    coef = torch.where(small, taylor, (1.0 - cot_term) / torch.where(small, one, theta_sq))
    V_inv = eye - 0.5 * W + coef * (W @ W)
    return torch.cat([torch.einsum("...ij,...j->...i", V_inv, mat[..., :3, 3]), w], -1)


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot_T = mat[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(rot_T, -torch.einsum("...ij,...j->...i", rot_T, mat[..., :3, 3]))


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 4, 4) transforms."""
    exact_f32()
    return a @ b


def se3_adjoint(mat: torch.Tensor) -> torch.Tensor:
    """Adjoint of a rigid transform: (..., 6, 6) acting on twists [v, w]."""
    exact_f32()
    rot = mat[..., :3, :3]
    top = torch.cat([rot, so3_hat(mat[..., :3, 3]) @ rot], -1)
    bottom = torch.cat([torch.zeros_like(rot), rot], -1)
    return torch.cat([top, bottom], -2)


# ---------------------------------------------------------------------------
# Quaternions (TUM interchange: [qx, qy, qz, qw])
# ---------------------------------------------------------------------------


def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w],
    qw >= 0 (scipy's convention up to global sign).

    Shepperd's method without branches: the largest of |qw|, |qx|, |qy|,
    |qz| from the diagonal, the other three from the off-diagonal sums and
    differences divided by it. The reference takes every component's
    magnitude from the diagonal (e.g. qx = sqrt(1 + m00 - m11 - m22) / 2),
    which for a small component turns a rounding error of 1e-7 in the
    matrix into ~1e-4 (the square root of it): a VO trajectory's
    near-identity rotations lose that much in its TUM files.
    """
    m00, m11, m22 = rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]
    d21, d02, d10 = rot[..., 2, 1] - rot[..., 1, 2], rot[..., 0, 2] - rot[..., 2, 0], rot[..., 1, 0] - rot[..., 0, 1]
    s01, s02, s12 = rot[..., 0, 1] + rot[..., 1, 0], rot[..., 0, 2] + rot[..., 2, 0], rot[..., 1, 2] + rot[..., 2, 1]
    t = torch.stack([
        1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22, 1.0 + (m00 + m11 + m22),
    ], -1)  # 4 qx^2, 4 qy^2, 4 qz^2, 4 qw^2
    big = 0.5 * torch.sqrt(t.amax(-1))  # the largest component: the four t sum to 4, so >= 1/2
    inv = 0.25 / big
    # Rows: the quaternion [x, y, z, w] when x, y, z or w is the largest.
    cand = torch.stack([
        torch.stack([big, s01 * inv, s02 * inv, d21 * inv], -1),
        torch.stack([s01 * inv, big, s12 * inv, d02 * inv], -1),
        torch.stack([s02 * inv, s12 * inv, big, d10 * inv], -1),
        torch.stack([d21 * inv, d02 * inv, d10 * inv, big], -1),
    ], -2)
    q = torch.take_along_dim(cand, t.argmax(-1)[..., None, None], -2)[..., 0, :]
    q = torch.where(q[..., 3:] < 0, -q, q)
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def make_intrinsics(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    """Scalars / batched scalars -> (..., 3, 3) intrinsics matrix."""
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=dtype, device=device) for v in (fx, fy, cx, cy))
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    rows = [[fx, zero, cx], [zero, fy, cy], [zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates, shape (3, H, W): rows (u, v, 1)."""
    u = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return torch.stack([u, v, torch.ones_like(u)], 0)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale intrinsics for an image resized by (sx, sy)."""
    scale = torch.tensor(
        [[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]], dtype=K.dtype, device=K.device
    )
    return K * scale


def intrinsics_pyramid(K: torch.Tensor, num_scales: int) -> list[torch.Tensor]:
    """Per-scale intrinsics for a /2 image pyramid (scale 0 = full res)."""
    return [scale_intrinsics(K, 0.5**s, 0.5**s) for s in range(num_scales)]


def pixel_to_cam(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project depth (..., H, W) through K (..., 3, 3) -> camera
    points (..., 3, H, W)."""
    h, w = depth.shape[-2], depth.shape[-1]
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("...ij,jhw->...ihw", torch.linalg.inv(K), grid)
    return rays * depth[..., None, :, :]


def cam_to_pixel(
    points: torch.Tensor, K: torch.Tensor, T: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform camera points (..., 3, H, W) by T (..., 4, 4) and
    project with K -> (pixel uv (..., 2, H, W), depth z (..., H, W)).
    |z| < 1e-8 divides by 1e-8, as the reference's `z_safe`."""
    rot = T[..., :3, :3]
    t = T[..., :3, 3]
    p = torch.einsum("...ij,...jhw->...ihw", rot, points) + t[..., :, None, None]
    proj = torch.einsum("...ij,...jhw->...ihw", K, p)
    z = proj[..., 2, :, :]
    z_safe = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return proj[..., :2, :, :] / z_safe[..., None, :, :], z


def trajectory_from_relatives(
    rel_mats: torch.Tensor, T0: torch.Tensor | None = None
) -> torch.Tensor:
    """(N, 4, 4) increments -> (N+1, 4, 4) absolute poses with
    poses[0] = T0 (identity by default), poses[k+1] = poses[k] @ rel[k].

    An inclusive prefix product in log2(N) doubling steps (Hillis-Steele),
    the counterpart of the reference's associative scan; it agrees with
    a sequential chain up to rounding.
    """
    exact_f32()
    eye = torch.eye(4, dtype=rel_mats.dtype, device=rel_mats.device)
    chained = rel_mats
    step = 1
    while step < len(chained):
        chained = torch.cat([chained[:step], chained[:-step] @ chained[step:]], 0)
        step *= 2
    poses = torch.cat([eye[None], chained], 0)
    return poses if T0 is None else T0[None] @ poses


def relative_from_trajectory(poses: torch.Tensor) -> torch.Tensor:
    """Absolute poses (N, 4, 4) -> relatives (N-1, 4, 4): inv(P_i) P_{i+1}."""
    exact_f32()
    return se3_inverse(poses[:-1]) @ poses[1:]
