"""Block-Jacobi preconditioned conjugate gradient for the reduced camera
system (port of davo_tpu.ba.pcg).

The direct LU of `schur.solve_window` is exact and cheap at 6M <= ~100;
this PCG works on the (M, M, 6, 6) block form for the many-keyframe
design point, its preconditioner the inverse of the 6x6 diagonal
blocks, with a fixed iteration count as the reference.
"""

from __future__ import annotations

import torch

from davo_tpu_torch import exact_f32
from davo_tpu_torch.ba.schur import check_info


def _block_matvec(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, M, 6, 6) x (M, 6) -> (M, 6)."""
    return torch.einsum("mpij,pj->mi", S, x)


def pcg_solve(
    S: torch.Tensor,
    rhs: torch.Tensor,
    iterations: int = 32,
    tol: float = 1e-6,
    n_fixed: int = 2,
) -> torch.Tensor:
    """Solve S x = rhs for pose updates with gauge clamping.

    S: (M, M, 6, 6); rhs: (M, 6). The first `n_fixed` poses are clamped
    to zero update (rows/cols projected out), as `schur.solve_window`.
    `tol` is kept for the reference's signature (fixed iteration count).
    """
    del tol
    exact_f32()
    M = S.shape[0]
    mask = torch.cat([
        torch.zeros(n_fixed, 6, dtype=S.dtype, device=S.device),
        torch.ones(M - n_fixed, 6, dtype=S.dtype, device=S.device),
    ])

    def A(x):
        return _block_matvec(S, x * mask) * mask

    m = torch.arange(M, device=S.device)
    diag_inv, info = torch.linalg.inv_ex(S[m, m] + 1e-8 * torch.eye(6, dtype=S.dtype, device=S.device))

    def Minv(r):
        return torch.einsum("mij,mj->mi", diag_inv, r) * mask

    b = rhs * mask
    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iterations):
        Ap = A(p)
        denom = (p * Ap).sum()
        alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    check_info(info, "pcg_solve's preconditioner")
    return x
