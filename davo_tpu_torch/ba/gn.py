"""Damped Gauss-Newton driver for one BA window (port of davo_tpu.ba.gn).

A fixed number of iterations (no data-dependent termination), Huber
IRLS reweighting in each. Poses update left-multiplicatively
(T <- exp(dx) T), landmarks additively. No host sync inside the loop:
the factorizations' status is gathered on the device and checked once,
after the last iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from davo_tpu_torch import exact_f32
from davo_tpu_torch.ba import residuals as res
from davo_tpu_torch.ba import schur
from davo_tpu_torch.config import BAConfig
from davo_tpu_torch.core import geometry as geo


class BAProblem(NamedTuple):
    """One fixed-shape BA window, float32 tensors on one device.

    poses_cw:     (M, 4, 4) world->camera
    points_w:     (N, 3)
    K:            (3, 3)
    observations: (M, N, 2) pixels
    mask:         (M, N) 1 where observed
    """

    poses_cw: torch.Tensor
    points_w: torch.Tensor
    K: torch.Tensor
    observations: torch.Tensor
    mask: torch.Tensor


def ba_cost(problem: BAProblem, delta: float) -> torch.Tensor:
    """Total Huber cost (for monitoring and tests)."""
    r = res.reprojection_residuals(
        problem.poses_cw, problem.points_w, problem.K, problem.observations, problem.mask
    )
    norm = torch.linalg.norm(r, dim=-1)
    return torch.where(norm <= delta, 0.5 * norm**2, delta * (norm - 0.5 * delta)).sum()


def _iterate(problem: BAProblem, cfg: BAConfig) -> tuple[BAProblem, torch.Tensor]:
    """One damped GN step and the worst status of its factorizations."""
    r = res.reprojection_residuals(
        problem.poses_cw, problem.points_w, problem.K, problem.observations, problem.mask
    )
    w = res.huber_weights(r, cfg.huber_delta, cfg.outlier_px) * problem.mask
    J_pose, J_point = res.reprojection_jacobians(
        problem.poses_cw, problem.points_w, problem.K, problem.mask
    )
    B, C, E, rhs_p, rhs_l = schur.gauss_newton_system(J_pose, J_point, r, w)
    S, rhs, C_inv, c_info = schur.schur_reduce(B, C, E, rhs_p, rhs_l, cfg.damping)
    dx_pose, s_info = schur.solve_window(S, rhs, n_fixed=2)
    dx_point = schur.backsubstitute(C_inv, E, rhs_l, dx_pose)
    new = problem._replace(
        poses_cw=geo.se3_exp(dx_pose) @ problem.poses_cw,
        points_w=problem.points_w + dx_point,
    )
    return new, torch.maximum(c_info.abs().max(), s_info.abs())


def ba_iteration(problem: BAProblem, cfg: BAConfig) -> BAProblem:
    """One damped GN step: linearize, Schur-reduce, solve, update."""
    exact_f32()
    new, info = _iterate(problem, cfg)
    schur.check_info(info, "ba_iteration")
    return new


def ba_refine(problem: BAProblem, cfg: BAConfig) -> BAProblem:
    """Run cfg.max_iterations damped GN steps on the problem's device;
    raises torch.linalg.LinAlgError if any factorization failed."""
    exact_f32()
    info = torch.zeros((), dtype=torch.int32, device=problem.poses_cw.device)
    for _ in range(cfg.max_iterations):
        problem, step_info = _iterate(problem, cfg)
        info = torch.maximum(info, step_info)
    schur.check_info(info, "ba_refine")
    return problem
