"""Gauss-Newton normal equations with Schur-complement reduction (port of
davo_tpu.ba.schur).

Each observation couples one pose and one landmark, so

    H = [[B, E], [E^T, C]],   B: (M, 6, 6) blkdiag, C: (N, 3, 3) blkdiag,
    E: (M, N, 6, 3)

Reduced camera system: S = B - E C^-1 E^T (6M x 6M dense),
  rhs_p' = rhs_p - E C^-1 rhs_l;  solve S dx_p = rhs_p';
  dx_l = C^-1 (rhs_l - E^T dx_p)   (parallel per landmark).

Every function takes optional leading axes (a batch of windows) through
the same einsums. The inverse and the solve are `torch.linalg.inv_ex` /
`solve_ex`: `inv` and `solve` check their status on the host, a sync per
call on the GPU, so these return the status instead (0 where the
factorization succeeded) and the caller checks it once per window.
"""

from __future__ import annotations

import torch

from davo_tpu_torch import exact_f32


def gauss_newton_system(
    J_pose: torch.Tensor,
    J_point: torch.Tensor,
    residuals: torch.Tensor,
    weights: torch.Tensor,
):
    """Assemble (B, C, E, rhs_pose, rhs_point) from Jacobians.

    J_pose: (..., M, N, 2, 6); J_point: (..., M, N, 2, 3); residuals:
    (..., M, N, 2); weights: (..., M, N) IRLS weights.
    """
    w = weights[..., None, None]
    B = torch.einsum("...mnri,...mnrj->...mnij", J_pose * w, J_pose).sum(-3)  # (..., M, 6, 6)
    C = torch.einsum("...mnri,...mnrj->...mnij", J_point * w, J_point).sum(-4)  # (..., N, 3, 3)
    E = torch.einsum("...mnri,...mnrj->...mnij", J_pose * w, J_point)  # (..., M, N, 6, 3)
    wr = residuals * weights[..., None]
    rhs_pose = -torch.einsum("...mnri,...mnr->...mi", J_pose, wr)
    rhs_point = -torch.einsum("...mnri,...mnr->...ni", J_point, wr)
    return B, C, E, rhs_pose, rhs_point


def schur_reduce(B, C, E, rhs_pose, rhs_point, damping: float):
    """Form the reduced camera system (S, rhs) with LM damping.

    Returns (S (..., M, M, 6, 6), rhs (..., M, 6), C_inv (..., N, 3, 3),
    info (..., N): the status of each landmark block's inverse).
    """
    M = B.shape[-3]
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    C_inv, info = torch.linalg.inv_ex(C + damping * eye3)
    ECi = torch.einsum("...mnij,...njk->...mnik", E, C_inv)  # (..., M, N, 6, 3)
    S_off = torch.einsum("...mnik,...pnlk->...mpil", ECi, E)  # (..., M, M, 6, 6)
    # The reference's S.at[m, m].set(diag), out of place: S is new.
    m = torch.arange(M, device=B.device)
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    S = -S_off
    S[..., m, m, :, :] = B + damping * eye6 - S_off[..., m, m, :, :]
    rhs = rhs_pose - torch.einsum("...mnik,...nk->...mi", ECi, rhs_point)
    return S, rhs, C_inv, info


def solve_window(S, rhs, n_fixed: int = 2):
    """Solve the reduced system for pose updates; returns (dx (..., M, 6),
    info (...,): the LU status).

    Gauge: clamp the first `n_fixed` poses (delta = 0) by zeroing their
    rows/cols and placing identity on their diagonal blocks. Monocular BA
    has a 7-DoF gauge (SE(3) + scale); anchoring TWO poses pins the scale
    through their baseline, which also chains sliding windows onto the
    already-refined past. The masked rows stay exact identity rows.
    """
    M = S.shape[-4]
    lead = S.shape[:-4]
    dense = S.transpose(-3, -2).reshape(*lead, 6 * M, 6 * M)
    b = rhs.reshape(*lead, 6 * M)
    if n_fixed:
        mask = torch.cat([
            torch.zeros(6 * n_fixed, dtype=S.dtype, device=S.device),
            torch.ones(6 * (M - n_fixed), dtype=S.dtype, device=S.device),
        ])
        dense = dense * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        b = b * mask
    # 6M <= ~100: a direct LU solve (a float32 Cholesky NaNs on the
    # ill-conditioned windows that sparse visibility gives).
    dx, info = torch.linalg.solve_ex(dense, b)
    return dx.reshape(*lead, M, 6), info


def backsubstitute(C_inv, E, rhs_point, dx_pose):
    """Landmark updates (..., N, 3), parallel per landmark."""
    Et_dx = torch.einsum("...mnij,...mi->...nj", E, dx_pose)
    return torch.einsum("...nij,...nj->...ni", C_inv, rhs_point - Et_dx)


def check_info(info: torch.Tensor, what: str) -> None:
    """Raise if any factorization behind `info` failed (one host sync)."""
    if info.numel() and int(info.abs().max()) != 0:
        raise torch.linalg.LinAlgError(f"{what}: a singular system (info {int(info.abs().max())})")


def solve_windows_batched(J_pose, J_point, residuals, weights,
                          damping: float = 1e-4, n_fixed: int = 2):
    """Solve K independent windows at once: inputs carry a leading window
    axis (J_pose (K, M, N, 2, 6), J_point (K, M, N, 2, 3), residuals
    (K, M, N, 2), weights (K, M, N)), carried through the same einsums
    and batched factorizations. Returns (dx_pose (K, M, 6), dx_point
    (K, N, 3)). A batch amortizes the per-op launch cost of a single
    window's chain of tiny ops across windows."""
    exact_f32()
    B, C, E, rp, rl = gauss_newton_system(J_pose, J_point, residuals, weights)
    S, rhs, C_inv, c_info = schur_reduce(B, C, E, rp, rl, damping)
    dxp, s_info = solve_window(S, rhs, n_fixed=n_fixed)
    dxl = backsubstitute(C_inv, E, rl, dxp)
    check_info(torch.cat([c_info.reshape(-1), s_info.reshape(-1)]), "solve_windows_batched")
    return dxp, dxl
