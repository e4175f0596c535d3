"""Pose-graph optimization, odometry smoothing (port of
davo_tpu.ba.posegraph).

Minimizes sum_e w_e ||log(Z_e^-1 C_i^-1 C_j)||^2 over absolute poses C
(cam-to-world), given relative measurements Z_e ~ C_i^-1 C_j (odometry
increments and any extra constraints, e.g. keyframe BA results or loop
closures). Gauss-Newton on the manifold: poses are perturbed
C_i <- C_i exp(x_i), the Jacobian by forward-mode autodiff of the whole
residual vector (`torch.func.jacfwd`, as the reference's `jax.jacfwd`).
"""

from __future__ import annotations

import torch

from davo_tpu_torch import exact_f32
from davo_tpu_torch.ba.schur import check_info
from davo_tpu_torch.core import geometry as geo


def _edge_residuals(x, poses, idx_i, idx_j, Z_inv, weights):
    """x: (P, 6) perturbations; returns (E, 6) weighted residuals."""
    C = poses @ geo.se3_exp(x)
    rel = geo.se3_inverse(C[idx_i]) @ C[idx_j]
    return geo.se3_log(Z_inv @ rel) * torch.sqrt(weights)[:, None]


def pose_graph_optimize(
    poses: torch.Tensor,
    idx_i: torch.Tensor,
    idx_j: torch.Tensor,
    Z: torch.Tensor,
    weights: torch.Tensor | None = None,
    iterations: int = 10,
    damping: float = 1e-6,
    fix_first: bool = True,
) -> torch.Tensor:
    """Optimize (P, 4, 4) poses given (E,) edges with (E, 4, 4) relative
    measurements Z, on the poses' device. Returns refined poses; raises
    torch.linalg.LinAlgError if a solve failed."""
    exact_f32()
    P = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    if weights is None:
        weights = torch.ones(idx_i.shape[0], dtype=dt, device=dev)
    Z_inv = geo.se3_inverse(Z)
    eye = torch.eye(P * 6, dtype=dt, device=dev)
    mask = torch.cat([torch.zeros(6, dtype=dt, device=dev), torch.ones(6 * (P - 1), dtype=dt, device=dev)])
    info = torch.zeros((), dtype=torch.int32, device=dev)
    C = poses
    for _ in range(iterations):
        def res_flat(x_flat, C=C):
            return _edge_residuals(x_flat.reshape(P, 6), C, idx_i, idx_j, Z_inv, weights).reshape(-1)

        x0 = torch.zeros(P * 6, dtype=dt, device=dev)
        r = res_flat(x0)
        J = torch.func.jacfwd(res_flat)(x0)  # (6E, 6P)
        H = J.T @ J + damping * eye
        g = J.T @ r
        if fix_first:
            H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
            g = g * mask
        dx, step_info = torch.linalg.solve_ex(H, g)
        info = torch.maximum(info, step_info.abs())
        C = C @ geo.se3_exp(-dx.reshape(P, 6))
    check_info(info, "pose_graph_optimize")
    return C
