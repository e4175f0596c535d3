"""davo_tpu_torch.ba against davo_tpu.ba on the CPU: the same numpy-seeded
windows through both packages.

Tolerances (float32 on both sides):
* residuals, Jacobians, the normal equations, S and rhs: 1e-5 of the
  largest element;
* what comes out of a float32 solve or inverse (C^-1, the updates dx of
  `solve_window`, `backsubstitute` and one `ba_iteration`): as accurate
  as the reference, no further from the same computation in float64
  than twice the reference's distance (or 1e-5 of the largest element),
  so within three times the reference's own float32 error of it. At
  these windows' condition numbers (kappa(S) ~ 3e4-5e4) either
  package's float32 LU lands 1e-5-5e-4 of the largest element from the
  float64 solve, so a fixed 1e-5 between the packages would hold only by
  chance. Without the gauge (n_fixed=0) the system is singular but for
  the damping; there both are held, as tests/test_ba.py holds the
  reference, by the residual of the normal equations (1e-3 relative);
* ba_refine on tests/test_ba.py's fixtures: refined poses within 1e-4 of
  the largest translation, the final Huber cost within 1e-3 relative;
* solve_windows_batched against the per-window solve: 1e-5 of the
  largest element (the same einsums with a window axis), and against
  the reference's vmap at the reference's own 2e-4;
* pcg_solve against solve_window on a well-conditioned window: 1e-4 of
  the largest update;
* pose_graph_optimize: poses within 1e-4 of the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.ba import gn as jgn
from davo_tpu.ba import pcg as jpcg
from davo_tpu.ba import posegraph as jposegraph
from davo_tpu.ba import residuals as jres
from davo_tpu.ba import schur as jschur
from davo_tpu.ba import window as jwindow
from davo_tpu.config import BAConfig as JBAConfig
from davo_tpu_torch.ba import gn, pcg, posegraph, residuals, schur, window
from davo_tpu_torch.config import BAConfig
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.data.synthetic import SyntheticSequence


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _se3_exp_np(xi):
    return geo.se3_exp(torch.as_tensor(np.asarray(xi), dtype=torch.float32)).numpy().astype(np.float64)


def make_problem(rng, M=4, N=60, noise=0.0, pose_noise=0.0, point_noise=0.0):
    """tests/test_ba.py's synthetic window as numpy: cameras in a rough
    arc looking at a landmark cloud around z ~ 8, the first two poses at
    GT (the gauge anchors). Returns (arrays of BAProblem's fields, GT
    world->camera poses)."""
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    pts = rng.uniform([-4, -3, 6], [4, 3, 10], size=(N, 3))
    poses_wc = np.stack([
        _se3_exp_np(np.concatenate([[i * 0.5 - M * 0.25, 0, 0], rng.normal(0, 0.02, 3)])) for i in range(M)
    ])
    poses_cw = np.linalg.inv(poses_wc)
    pix, z = residuals.project_points(*(torch.as_tensor(a, dtype=torch.float32) for a in (poses_cw, pts, K)))
    pix, z = pix.numpy(), z.numpy()
    mask = ((z > 0.1) & (pix[..., 0] >= 0) & (pix[..., 0] <= 127)
            & (pix[..., 1] >= 0) & (pix[..., 1] <= 95)).astype(np.float32)
    obs = pix + rng.normal(0, noise, pix.shape)
    poses_cw_init = poses_cw.copy()
    for i in range(2, M):
        poses_cw_init[i] = _se3_exp_np(rng.normal(0, pose_noise, 6)) @ poses_cw_init[i]
    pts_init = pts + rng.normal(0, point_noise, pts.shape)
    arrays = [np.asarray(a, np.float32) for a in (poses_cw_init, pts_init, K, obs, mask)]
    return arrays, poses_cw


def _port(arrays):
    return gn.BAProblem(*(torch.from_numpy(a.copy()) for a in arrays))


def _ref(arrays):
    return jgn.BAProblem(*(jnp.asarray(a) for a in arrays))


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _as_accurate_as_reference(got, want, exact, what=""):
    """The float32 solve criterion of the module docstring; `exact` is
    the same computation in float64."""
    got, want, exact = (np.asarray(x, np.float64) for x in (got, want, exact))
    scale = np.abs(exact).max()
    assert got.shape == want.shape == exact.shape, what
    err, ref_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    assert err <= max(2.0 * ref_err, 1e-5 * scale), (what, err, ref_err, scale)


def _linearize(mod, problem):
    r = mod.reprojection_residuals(problem.poses_cw, problem.points_w, problem.K, problem.observations, problem.mask)
    Jp, Jl = mod.reprojection_jacobians(problem.poses_cw, problem.points_w, problem.K, problem.mask)
    return r, Jp, Jl


def test_residuals_and_jacobians_match_reference(rng):
    arrays, _ = make_problem(rng, M=4, N=40, noise=0.5, pose_noise=0.03, point_noise=0.05)
    got = _linearize(residuals, _port(arrays))
    want = _linearize(jres, _ref(arrays))
    for g, w, name in zip(got, want, ("residuals", "J_pose", "J_point")):
        _close_rel(g.numpy(), w, 1e-5, name)
    pix, z = residuals.project_points(*(torch.from_numpy(a) for a in arrays[:3]))
    jpix, jz = jres.project_points(*(jnp.asarray(a) for a in arrays[:3]))
    _close_rel(pix.numpy(), jpix, 1e-5, "pixels")
    _close_rel(z.numpy(), jz, 1e-5, "z")
    r = got[0]
    for cutoff in (None, 2.0):
        np.testing.assert_allclose(
            residuals.huber_weights(r, 1.0, cutoff).numpy(),
            np.asarray(jres.huber_weights(jnp.asarray(r.numpy()), 1.0, cutoff)), rtol=0, atol=1e-6,
        )


@pytest.mark.parametrize("n_fixed", [0, 2])
def test_normal_equations_and_schur_solve_match_reference(rng, n_fixed):
    arrays, _ = make_problem(rng, M=4, N=20, noise=0.5, pose_noise=0.02)
    r, Jp, Jl = _linearize(residuals, _port(arrays))
    w = torch.from_numpy(arrays[4]) * torch.from_numpy(rng.uniform(0.5, 1.0, arrays[4].shape).astype(np.float32))
    jr, jJp, jJl, jw = (jnp.asarray(t.numpy()) for t in (r, Jp, Jl, w))
    got = schur.gauss_newton_system(Jp, Jl, r, w)
    want = jschur.gauss_newton_system(jJp, jJl, jr, jw)
    for g, wnt, name in zip(got, want, ("B", "C", "E", "rhs_pose", "rhs_point")):
        _close_rel(g.numpy(), wnt, 1e-5, name)
    S, rhs, C_inv, c_info = schur.schur_reduce(*got, 1e-3)
    jS, jrhs, jC_inv = jschur.schur_reduce(*want, 1e-3)
    _, _, C_inv64, _ = schur.schur_reduce(*(g.double() for g in got), 1e-3)
    assert int(c_info.abs().max()) == 0
    _close_rel(S.numpy(), jS, 1e-5, "S")
    _close_rel(rhs.numpy(), jrhs, 1e-5, "rhs")
    _as_accurate_as_reference(C_inv, jC_inv, C_inv64, "C_inv")
    # The solves of the same float32 system.
    dx, s_info = schur.solve_window(S, rhs, n_fixed=n_fixed)
    jdx = jschur.solve_window(jS, jrhs, n_fixed=n_fixed)
    assert int(s_info) == 0
    if not n_fixed:
        dense = S.double().transpose(1, 2).reshape(24, 24).numpy()
        b = rhs.double().reshape(-1).numpy()
        for x in (dx.numpy(), np.asarray(jdx)):
            assert np.linalg.norm(dense @ x.reshape(-1) - b) / np.linalg.norm(b) < 1e-3
        return
    dx64, _ = schur.solve_window(S.double(), rhs.double(), n_fixed=n_fixed)
    _as_accurate_as_reference(dx, jdx, dx64, "dx_pose")
    assert not dx[:n_fixed].any()  # the gauge rows stay exact identity rows
    E, rl = got[2], got[4]
    _as_accurate_as_reference(
        schur.backsubstitute(C_inv, E, rl, dx), jschur.backsubstitute(jC_inv, want[2], want[4], jdx),
        schur.backsubstitute(C_inv.double(), E.double(), rl.double(), dx.double()), "dx_point",
    )


def test_one_ba_iteration_matches_reference(rng):
    arrays, _ = make_problem(rng, M=5, N=60, noise=0.3, pose_noise=0.03, point_noise=0.05)
    cfg, jcfg = BAConfig(damping=1e-3, huber_delta=1.0), JBAConfig(damping=1e-3, huber_delta=1.0)
    got = gn.ba_iteration(_port(arrays), cfg)
    want = jgn.ba_iteration(_ref(arrays), jcfg)
    exact = gn.ba_iteration(gn.BAProblem(*(torch.from_numpy(a.astype(np.float64)) for a in arrays)), cfg)
    # The update: each pose's step from its start, each landmark's step.
    start = np.linalg.inv(arrays[0].astype(np.float64))
    _as_accurate_as_reference(got.poses_cw.numpy() @ start - np.eye(4), np.asarray(want.poses_cw) @ start - np.eye(4),
                              exact.poses_cw.numpy() @ start - np.eye(4), "pose step")
    _as_accurate_as_reference(got.points_w.numpy() - arrays[1], np.asarray(want.points_w) - arrays[1],
                              exact.points_w.numpy() - arrays[1], "dx_point")


def _refine_both(arrays, cfg_kw):
    got = gn.ba_refine(_port(arrays), BAConfig(**cfg_kw))
    want = jgn.ba_refine(_ref(arrays), JBAConfig(**cfg_kw))
    largest_t = np.abs(np.asarray(want.poses_cw)[:, :3, 3]).max()
    np.testing.assert_allclose(got.poses_cw.numpy(), np.asarray(want.poses_cw), rtol=0, atol=1e-4 * largest_t)
    return got, want


def test_ba_refine_converges_from_perturbation_as_reference(rng):
    arrays, gt_cw = make_problem(rng, M=5, N=80, noise=0.0, pose_noise=0.03, point_noise=0.05)
    got, want = _refine_both(arrays, dict(max_iterations=15, damping=1e-4, huber_delta=5.0))
    c0 = float(gn.ba_cost(_port(arrays), 5.0))
    c1, jc1 = float(gn.ba_cost(got, 5.0)), float(jgn.ba_cost(want, 5.0))
    np.testing.assert_allclose(c0, float(jgn.ba_cost(_ref(arrays), 5.0)), rtol=1e-5)
    # Both land at the float32 floor (the data are noise-free); below
    # that the cost is rounding, so the agreement is held at the floor.
    assert c1 < c0 * 1e-3 and jc1 < c0 * 1e-3, (c0, c1, jc1)
    np.testing.assert_allclose(c1, jc1, rtol=1e-3, atol=1e-6 * c0)
    t_err = np.linalg.norm((got.poses_cw.numpy() @ np.linalg.inv(gt_cw))[:, :3, 3], axis=-1)
    assert t_err.max() < 5e-3


def test_ba_refine_robust_to_outliers_as_reference(rng):
    arrays, gt_cw = make_problem(rng, M=4, N=60, noise=0.2, pose_noise=0.02)
    idx = rng.choice(60, 6, replace=False)
    arrays[3][:, idx] += rng.normal(0, 40.0, arrays[3][:, idx].shape).astype(np.float32)
    kw = dict(max_iterations=15, damping=1e-3, huber_delta=1.0, outlier_px=16.0)
    got, want = _refine_both(arrays, kw)
    c1, jc1 = float(gn.ba_cost(got, 1.0)), float(jgn.ba_cost(want, 1.0))
    np.testing.assert_allclose(c1, jc1, rtol=1e-3)
    t_err = np.linalg.norm((got.poses_cw.numpy() @ np.linalg.inv(gt_cw))[:, :3, 3], axis=-1)
    assert t_err.max() < 0.1


def test_singular_window_raises_instead_of_returning_nan(rng):
    """A landmark no frame sees, undamped: its 3x3 block is singular. The
    reference returns non-finite poses; the port checks the status once
    per window and raises."""
    arrays, _ = make_problem(rng, M=4, N=20, noise=0.3, pose_noise=0.02)
    arrays[4][:, 0] = 0.0
    want = jgn.ba_refine(_ref(arrays), JBAConfig(max_iterations=2, damping=0.0))
    assert not np.isfinite(np.asarray(want.poses_cw)).all()
    with pytest.raises(torch.linalg.LinAlgError, match="ba_refine"):
        gn.ba_refine(_port(arrays), BAConfig(max_iterations=2, damping=0.0))


def _random_windows(K=3, M=6, N=64, seed=3):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(K, M, N, 2, 6)).astype(np.float32),
        rng.normal(size=(K, M, N, 2, 3)).astype(np.float32),
        rng.normal(size=(K, M, N, 2)).astype(np.float32),
        rng.uniform(0.1, 1.0, (K, M, N)).astype(np.float32),
    ]


def test_solve_windows_batched_matches_sequential_and_reference():
    arrays = _random_windows()
    Jp, Jl, r, w = (torch.from_numpy(a) for a in arrays)
    dxp_b, dxl_b = schur.solve_windows_batched(Jp, Jl, r, w)
    jdxp_b, jdxl_b = jschur.solve_windows_batched(*(jnp.asarray(a) for a in arrays))
    for k in range(len(arrays[0])):
        B, C, E, rp, rl = schur.gauss_newton_system(Jp[k], Jl[k], r[k], w[k])
        S, rhs, C_inv, _ = schur.schur_reduce(B, C, E, rp, rl, 1e-4)
        dxp, _ = schur.solve_window(S, rhs)
        dxl = schur.backsubstitute(C_inv, E, rl, dxp)
        _close_rel(dxp_b[k].numpy(), dxp.numpy(), 1e-5, "dx_pose")
        _close_rel(dxl_b[k].numpy(), dxl.numpy(), 1e-5, "dx_point")
        np.testing.assert_allclose(dxp_b[k].numpy(), np.asarray(jdxp_b[k]), rtol=0, atol=2e-4)
        np.testing.assert_allclose(dxl_b[k].numpy(), np.asarray(jdxl_b[k]), rtol=0, atol=2e-4)


def test_pcg_solve_matches_solve_window_and_reference(rng):
    arrays, _ = make_problem(rng, M=5, N=80, noise=0.5, pose_noise=0.02)
    r, Jp, Jl = _linearize(residuals, _port(arrays))
    B, C, E, rp, rl = schur.gauss_newton_system(Jp, Jl, r, torch.from_numpy(arrays[4]))
    S, rhs, _, _ = schur.schur_reduce(B, C, E, rp, rl, 1e-2)
    direct, _ = schur.solve_window(S, rhs)
    got = pcg.pcg_solve(S, rhs, iterations=32)
    _close_rel(got.numpy(), direct.numpy(), 1e-4, "pcg against LU")
    want = jpcg.pcg_solve(jnp.asarray(S.numpy()), jnp.asarray(rhs.numpy()), iterations=32)
    _close_rel(got.numpy(), want, 1e-4, "pcg against the reference")


def _chain(rng, P=12):
    gt_rel = _se3_exp_np(rng.normal(0, 0.1, (P - 1, 6)))
    gt = geo.trajectory_from_relatives(torch.as_tensor(gt_rel, dtype=torch.float32)).numpy()
    noisy_rel = _se3_exp_np(rng.normal(0, 0.02, (P - 1, 6))) @ gt_rel
    init = geo.trajectory_from_relatives(torch.as_tensor(noisy_rel, dtype=torch.float32)).numpy()
    idx_i, idx_j, Z = list(range(P - 1)), list(range(1, P)), list(noisy_rel)
    for i in range(P - 2):
        idx_i.append(i)
        idx_j.append(i + 2)
        Z.append(_se3_exp_np(rng.normal(0, 0.005, 6)) @ np.linalg.inv(gt[i]) @ gt[i + 2])
    return gt, init, np.array(idx_i), np.array(idx_j), np.stack(Z).astype(np.float32)


def _pose_graph_both(init, idx_i, idx_j, Z, iterations):
    got = posegraph.pose_graph_optimize(
        torch.from_numpy(init.astype(np.float32)), torch.from_numpy(idx_i), torch.from_numpy(idx_j),
        torch.from_numpy(Z), iterations=iterations,
    ).numpy()
    want = np.asarray(jposegraph.pose_graph_optimize(
        jnp.asarray(init, jnp.float32), jnp.asarray(idx_i), jnp.asarray(idx_j), jnp.asarray(Z),
        iterations=iterations,
    ))
    return got, want


def test_pose_graph_smooths_a_noisy_chain_as_reference(rng):
    gt, init, idx_i, idx_j, Z = _chain(rng)
    got, want = _pose_graph_both(init, idx_i, idx_j, Z, iterations=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want[:, :3, 3]).max()))
    err_before = np.linalg.norm(init[:, :3, 3] - gt[:, :3, 3], axis=-1).mean()
    err_after = np.linalg.norm(got[:, :3, 3] - gt[:, :3, 3], axis=-1).mean()
    assert err_after < err_before * 0.8


def test_pose_graph_on_exactly_consistent_edges_stays_finite(rng):
    """Edges that agree exactly put every residual at the identity, where
    se3_log's tangent would be NaN without the double `where`."""
    gt, _, idx_i, idx_j, _ = _chain(rng, P=6)
    Z = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(idx_i, idx_j)]).astype(np.float32)
    got, want = _pose_graph_both(gt, idx_i, idx_j, Z, iterations=3)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, gt, rtol=0, atol=1e-4)


def test_window_starts_match_reference():
    for n in range(1, 40):
        for m in (3, 4, 5, 6, 8):
            for stride in (1, max(m // 2, 1), m):
                assert window.window_starts(n, m, stride) == jwindow.window_starts(n, m, stride)


def test_sliding_window_refines_as_reference(rng):
    """tests/test_ba.py's window: observations from GT geometry, the pose
    initialization perturbed; one window through both packages, then the
    whole trajectory through SlidingWindowBA."""
    seq = SyntheticSequence(n_frames=10, height=48, width=64, seed=2, plane_z=15.0, forward_speed=1.0)
    gt_wc = seq.poses.copy()
    depths = np.stack([seq.depth(i) for i in range(10)])
    noisy = gt_wc.copy()
    for i in range(2, 10):
        noisy[i] = noisy[i] @ _se3_exp_np(rng.normal(0, 0.01, 6))
    kw = dict(window_size=6, max_iterations=8, damping=1e-4, huber_delta=3.0)
    prob = window.build_window_problem(gt_wc[:6], depths[:6], seq.K, step=8, device="cpu")
    jprob = jwindow.build_window_problem(gt_wc[:6], depths[:6], seq.K, step=8)
    for g, w in zip(prob, jprob):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    init = np.linalg.inv(noisy[:6]).astype(np.float32)
    got = gn.ba_refine(prob._replace(poses_cw=torch.from_numpy(init)), BAConfig(**kw))
    want = jgn.ba_refine(jprob._replace(poses_cw=jnp.asarray(init)), JBAConfig(**kw))
    np.testing.assert_allclose(got.poses_cw.numpy(), np.asarray(want.poses_cw), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want.poses_cw)[:, :3, 3]).max())
    ref_wc = np.linalg.inv(got.poses_cw.numpy())
    err_before = np.linalg.norm(noisy[:6, :3, 3] - gt_wc[:6, :3, 3], axis=-1).mean()
    assert np.linalg.norm(ref_wc[:, :3, 3] - gt_wc[:6, :3, 3], axis=-1).mean() < err_before * 0.2

    out = window.SlidingWindowBA(BAConfig(**kw), device="cpu").refine_trajectory(noisy, depths, seq.K,
                                                                                   obs_poses=gt_wc)
    jout = jwindow.SlidingWindowBA(JBAConfig(**kw)).refine_trajectory(noisy, depths, seq.K, obs_poses=gt_wc)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-4 * np.abs(jout[:, :3, 3]).max())


def test_ba_entry_points_default_to_the_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    seq = SyntheticSequence(n_frames=4, height=16, width=24, seed=0)
    depths = np.stack([seq.depth(i) for i in range(4)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window.build_window_problem(seq.poses, depths, seq.K)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window.SlidingWindowBA(BAConfig())
