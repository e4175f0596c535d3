"""davo_tpu_torch.core.geometry's Lie groups, quaternions and trajectory
algebra against davo_tpu.core.geometry on the CPU.

Tolerance: 1e-5 absolute on every output (float32 on both sides, the
same closed forms), including the Taylor seams at theta -> 0, the
near-pi branch, the Shepperd case about [0, 1, -1]/sqrt(2), and
forward-mode Jacobians at the zero twist.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.core import geometry as jgeo
from davo_tpu_torch.core import geometry as geo

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _both(fn_name, *arrays, **kw):
    """(port result, reference result) as numpy, same float32 inputs."""
    got = getattr(geo, fn_name)(*(torch.from_numpy(np.array(a, np.float32)) for a in arrays), **kw)
    want = getattr(jgeo, fn_name)(*(jnp.asarray(a, jnp.float32) for a in arrays), **kw)
    return np.asarray(got), np.asarray(want)


def _rotvecs(rng):
    """Axis-angles across every branch: generic, theta -> 0 around the
    Taylor seams (0.1 and 1e-4), exactly 0, near and at pi, and pi about
    [0, 1, -1]/sqrt(2) (the case that breaks an x-anchored sign fix)."""
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    thetas = np.array([0.0, 1e-7, 1e-5, 9.9e-5, 1.01e-4, 0.05, 0.0999, 0.1001, 0.7, 2.0, np.pi - 1e-3, np.pi - 5e-5])
    shepperd = np.array([0.0, 1.0, -1.0]) / np.sqrt(2.0) * np.pi
    return np.concatenate([axes * thetas[:, None], rng.normal(0, 1.0, (6, 3)), shepperd[None]])


def test_hat_vee_round_trip(rng):
    w = rng.normal(size=(5, 3))
    got, want = _both("so3_hat", w)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(geo.so3_vee(torch.from_numpy(got)).numpy(), w, rtol=0, atol=1e-6)


def test_so3_exp_and_log_match_reference(rng):
    w = _rotvecs(rng)
    R, R_ref = _both("so3_exp", w)
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=TOL)
    got, want = _both("so3_log", R_ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # The Shepperd case comes back as the same rotation as the reference
    # gives; both within 1e-3 of the input (the near-pi branch's sqrt of
    # axis^2 + 1e-8 biases a zero axis component by 1e-4).
    back = geo.so3_exp(torch.from_numpy(got[-1:])).numpy()
    np.testing.assert_allclose(back, np.asarray(jgeo.so3_exp(jnp.asarray(want[-1:]))), rtol=0, atol=TOL)
    np.testing.assert_allclose(back, R_ref[-1:], rtol=0, atol=1e-3)


def test_se3_exp_log_inverse_adjoint_match_reference(rng):
    xi = np.concatenate([rng.normal(0, 2.0, (len(_rotvecs(rng)), 3)), _rotvecs(rng)], -1)
    T, T_ref = _both("se3_exp", xi)
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=TOL)
    for name in ("se3_log", "se3_inverse", "se3_adjoint"):
        got, want = _both(name, T_ref)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()), err_msg=name)
    got, want = _both("se3_compose", T_ref[:6], T_ref[6:12])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 10)


@pytest.mark.parametrize("rotation", ["axis_angle", "euler"])
def test_pose_vec_round_trip_matches_reference(rng, rotation):
    vec = np.concatenate([rng.normal(size=(7, 3)), rng.normal(0, 0.5, (7, 3))], -1)
    T, T_ref = _both("pose_vec_to_mat", vec, rotation=rotation)
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=TOL)
    got, want = _both("mat_to_pose_vec", T_ref, rotation=rotation)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_unknown_rotation_is_refused():
    with pytest.raises(ValueError, match="unknown rotation"):
        geo.pose_vec_to_mat(torch.zeros(6), rotation="quat")
    with pytest.raises(ValueError, match="unknown rotation"):
        geo.mat_to_pose_vec(torch.eye(4), rotation="quat")


def test_quaternions_match_scipy_and_reference(rng):
    """mat_to_quat against scipy's quaternion of the same rotation vector
    within 1e-6 (up to the global sign at qw = 0), and the reference's
    within 1e-5 where every component is at least 0.05. The reference
    takes each magnitude from the diagonal (qx = sqrt(1 + m00 - m11 -
    m22) / 2), so a small component carries the square root of the
    matrix's float32 rounding, ~1e-4: the port uses Shepperd's method."""
    from scipy.spatial.transform import Rotation

    w = _rotvecs(rng)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w, jnp.float32)))
    q, q_ref = _both("mat_to_quat", R)
    truth = Rotation.from_rotvec(w).as_quat()
    truth = np.where(truth[:, 3:] < 0, -truth, truth)
    err = np.minimum(np.abs(q - truth).max(-1), np.abs(q + truth).max(-1))
    assert err.max() < 1e-6, err
    large = (np.abs(truth) >= 0.05).all(-1)
    np.testing.assert_allclose(q[large], q_ref[large], rtol=0, atol=TOL)
    assert np.abs(q_ref - truth).max() > 1e-5  # the reference's small components
    got, want = _both("quat_to_mat", q_ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_intrinsics_and_relatives_match_reference(rng):
    got = geo.make_intrinsics(np.array([100.0, 200.0]), 90.0 * np.ones(2), 64.0 * np.ones(2), 48.0 * np.ones(2))
    want = jgeo.make_intrinsics(jnp.array([100.0, 200.0]), 90.0 * jnp.ones(2), 64.0 * jnp.ones(2),
                                48.0 * jnp.ones(2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 3)
    xi = np.concatenate([rng.normal(size=(6, 3)), rng.normal(0, 0.3, (6, 3))], -1)
    poses = np.asarray(jgeo.se3_exp(jnp.asarray(xi, jnp.float32)))
    got, want = _both("relative_from_trajectory", poses)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 10)


def test_jacfwd_at_the_zero_twist_is_finite_and_matches_reference():
    """Exactly consistent pose-graph edges put se3_log at the identity;
    the double `where` and the clip's half gradient at its tie keep the
    forward-mode Jacobian finite and equal to JAX's."""

    def f_ref(x):
        return jgeo.se3_log(jgeo.se3_exp(x) @ jgeo.se3_exp(-x))

    def f(x):
        return geo.se3_log(geo.se3_exp(x) @ geo.se3_exp(-x))

    # Batched inputs, as the pose graph's edges: torch.func (2.13) widens a
    # 0-d tangent times a Python float to float64.
    for name, x in (("zero", np.zeros((2, 6))), ("small", np.full((2, 6), 1e-3))):
        got = torch.func.jacfwd(f)(torch.from_numpy(x.astype(np.float32))).numpy()
        want = np.asarray(jax.jacfwd(f_ref)(jnp.asarray(x, jnp.float32)))
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)
    got = torch.func.jacfwd(geo.so3_log)(torch.eye(3).repeat(2, 1, 1)).numpy()
    want = np.asarray(jax.jacfwd(jgeo.so3_log)(jnp.tile(jnp.eye(3), (2, 1, 1))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
