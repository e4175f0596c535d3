"""Sliding-window bundle adjustment + pose-graph backend (port of
davo_tpu.ba, single host; the sharded BA is not ported yet).

* Fixed-shape dense observation grid: M keyframes x N landmarks with a
  visibility mask; residuals (M, N, 2), Jacobians (M, N, 2, 6) / (2, 3)
  in closed form, everything batched.
* Each observation couples one pose and one landmark, so the
  Gauss-Newton Hessian is blocked: B (6x6 per pose), C (3x3 per
  landmark, inverted in parallel), E (pose-landmark). The reduced camera
  system S = B - E C^-1 E^T (6M x 6M) is solved by LU or block-Jacobi
  PCG; landmarks back-substitute in parallel.
* Everything runs in true float32 (TF32 off, `davo_tpu_torch.exact_f32`):
  SE(3) chains and Schur solves do not survive TF32.
"""

from davo_tpu_torch.ba.residuals import (  # noqa: F401
    project_points,
    reprojection_residuals,
    reprojection_jacobians,
    huber_weights,
)
from davo_tpu_torch.ba.schur import (  # noqa: F401
    gauss_newton_system,
    schur_reduce,
    solve_window,
    backsubstitute,
)
from davo_tpu_torch.ba.gn import ba_refine, BAProblem  # noqa: F401
from davo_tpu_torch.ba.posegraph import pose_graph_optimize  # noqa: F401
from davo_tpu_torch.ba.window import SlidingWindowBA  # noqa: F401
