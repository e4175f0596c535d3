"""Geometry-grounded pose: dense flow + depth -> 6-DoF (port of
davo_tpu.models.geopose).

`pose_from_flow` is a differentiable dense Gauss-Newton solve of

    min_T  sum_x w(x) || pi(K (R X(x) + t)) - (x + u(x)) ||^2

with X(x) = Z(x) K^-1 x_h, run a fixed number of iterations: each is
two einsum contractions to a (B, 6, 6) system and a batched 6x6 solve.
Gradients flow to `flow`, `depth` and `weight` through autograd. The
solve is `torch.linalg.solve_ex` without its error check, as the
reference's `jnp.linalg.solve` checks nothing: the iterations read no
value back to the host.

Conventions as the package's: flow maps target pixel x to its
source-frame position x + u, and the returned pose vector [tx ty tz rx
ry rz] (Euler) is the target-cam -> source-cam transform, the object
the conv pose head regresses.
"""

from __future__ import annotations

import torch

from davo_tpu_torch.core import geometry as geo


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2
    )


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """`jnp.maximum(x, c)`: half the gradient passes at a tie, as JAX's;
    the constant is filled on x's device, not copied from the host."""
    return torch.maximum(x, x.new_full((), c))


def pose_from_flow(
    flow: torch.Tensor,
    depth: torch.Tensor,
    K: torch.Tensor,
    weight: torch.Tensor | None = None,
    iters: int = 3,
    damping: float = 1e-3,
    min_depth: float = 0.1,
    robust_delta: float = 0.0,
    step_clip: float = 0.0,
) -> torch.Tensor:
    """Dense GN solve for the target->source pose explaining `flow`.

    flow: (B, H, W, 2) pixel displacement (du, dv), x_src = x + u;
    depth: (B, H, W) target-frame depth; K: (3, 3), (1, 3, 3) or
    (B, 3, 3) intrinsics at flow resolution; weight: optional (B, H, W)
    confidence (>= 0), the in-frame validity of x + u always applied on
    top; robust_delta > 0: IRLS Huber weights beyond that many pixels;
    step_clip > 0 caps each update's 6-vector norm (a trust region).
    Each iteration's system is damped by damping * (trace / 6 + 1e-6)
    and its update applied on the left: R <- exp(dw) R, t <- exp(dw) t +
    dt. Returns (B, 6) pose vectors [t, euler] in the model convention.
    """
    B, H, W, _ = flow.shape
    flow = flow.float()
    depth = _maximum(depth.float(), min_depth)
    K = K.float()
    K = K.expand(B, 3, 3) if K.dim() == 2 or K.shape[0] == 1 else K

    grid = geo.pixel_grid(H, W, torch.float32, flow.device)  # (3, H, W)
    Xf = geo.pixel_to_cam(depth, K).reshape(B, 3, H * W)
    target_px = (grid[None, :2] + flow.movedim(-1, 1)).reshape(B, 2, H * W)

    # Validity: the matched position must land in frame.
    u_t, v_t = target_px[:, 0], target_px[:, 1]
    w = ((u_t >= 0.0) & (u_t <= W - 1.0) & (v_t >= 0.0) & (v_t <= H - 1.0)).float()
    if weight is not None:
        w = w * _maximum(weight.float(), 0.0).reshape(B, H * W)
    # Normalised so the damping term has a stable relative magnitude.
    w = w / (w.mean(1, keepdim=True) + 1e-8)

    R = torch.eye(3, dtype=torch.float32, device=flow.device).expand(B, 3, 3)
    t = flow.new_zeros(B, 3)
    eye6 = torch.eye(6, dtype=torch.float32, device=flow.device)
    for _ in range(iters):
        P = torch.einsum("bij,bjn->bin", R, Xf) + t[:, :, None]
        q = torch.einsum("bij,bjn->bin", K, P)
        qz = _maximum(q[:, 2], min_depth)
        px = q[:, 0] / qz
        py = q[:, 1] / qz
        r = torch.stack([px, py], 1) - target_px  # (B, 2, N)
        wi = w
        if robust_delta > 0.0:
            rn = torch.sqrt((r * r).sum(1) + 1e-12)
            wi = w * (robust_delta / _maximum(rn, robust_delta))
        # d(px)/dP = (K_row0 - px * K_row2) / qz.
        Jp = torch.stack(
            [
                K[:, 0, :, None] - px[:, None, :] * K[:, 2, :, None],
                K[:, 1, :, None] - py[:, None, :] * K[:, 2, :, None],
            ],
            1,
        ) / qz[:, None, None, :]  # (B, 2, 3, N)
        # Left SE(3) perturbation: dP/d(dt) = I, dP/d(dw) = -[P]x.
        dPdw = -_skew(P.movedim(1, -1))  # (B, N, 3, 3)
        Jw = torch.einsum("bpcn,bncw->bpwn", Jp, dPdw)
        J = torch.cat([Jp, Jw], 2)  # (B, 2, 6, N)

        Hm = torch.einsum("bpin,bpjn,bn->bij", J, J, wi)
        g = torch.einsum("bpin,bpn,bn->bi", J, r, wi)
        lam = damping * (torch.diagonal(Hm, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0 + 1e-6)
        delta = -torch.linalg.solve_ex(Hm + lam * eye6, g[..., None], check_errors=False).result[..., 0]
        if step_clip > 0.0:
            nrm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
            delta = delta * torch.minimum(
                delta.new_ones(()), step_clip / _maximum(nrm, 1e-12)
            )
        Rd = geo.so3_exp(delta[:, 3:])
        R = torch.einsum("bij,bjk->bik", Rd, R)
        t = torch.einsum("bij,bj->bi", Rd, t) + delta[:, :3]

    return geo.mat_to_pose_vec(geo.rt_to_mat(R, t), "euler")


def pose_from_flow_pyramid(
    flow_level: torch.Tensor,
    depth_full: torch.Tensor,
    K_full: torch.Tensor,
    full_hw: tuple[int, int],
    weight: torch.Tensor | None = None,
    iters: int = 3,
    damping: float = 1e-3,
    robust_delta: float = 0.0,
    step_clip: float = 0.0,
) -> torch.Tensor:
    """Solve at a pyramid level's own resolution.

    flow_level: (B, h, w, 2) in level-pixel units (the flow net's
    output); depth_full: (B, H, W), sampled here by striding; K_full
    ((3, 3) or (B, 3, 3)) is rescaled to the level grid (fx, cx by
    w / W; fy, cy by h / H). The stride must divide the full
    resolution, as the reference asserts.
    """
    _, h, wd, _ = flow_level.shape
    H, W = full_hw
    if H % h or W % wd:
        raise ValueError(f"pyramid stride must divide the full res: {(H, W)} vs {(h, wd)}")
    sy, sx = H // h, W // wd
    depth = depth_full[:, ::sy, ::sx][:, :h, :wd]
    if K_full.dim() == 2:
        K_full = K_full[None]
    K_full = K_full.float()
    Kl = torch.cat([K_full[:, :1] * (wd / W), K_full[:, 1:2] * (h / H), K_full[:, 2:]], 1)
    return pose_from_flow(
        flow_level, depth, Kl, weight=weight, iters=iters, damping=damping,
        robust_delta=robust_delta, step_clip=step_clip,
    )
