"""Bundle adjustment on windows whose anchors lie 0.5 mm apart: the port's
`ba_refine` iterations against the reference's (CPU).

A random-weight `davo` moves the camera ~0.5 mm a frame, so `cli ba`'s
net-backed windows have their two gauge anchors (the first two poses,
held fixed) 0.5 mm apart, and the damped Gauss-Newton steps (fixed
damping, no step control) raise the Huber cost in some of them (2 of 7
on the card). Here eight cameras 0.5 mm apart look at 96 landmarks 4-20 m
away, observed with 0.5 px of flow noise, the landmarks' depths 10 % off
and the free poses perturbed by 2 mrad / 2 mm. The window is so nearly
singular along the scale the anchors leave free that a float32 solve is
rounding-bound (either package's float32 cost lands tens of percent
from its float64 run after one step), so the two are compared in
float64, where each iteration's Huber cost must agree within 1e-4
relative over 10 iterations (float64 rounding, amplified by those
solves, parts them by up to 1.2e-5 at a 13x rise; float32 by tens of
percent); and in some of these windows the cost must rise in both
alike: the rise is the reference's damped Gauss-Newton.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ba import _se3_exp_np

from davo_tpu.ba import gn as jgn
from davo_tpu.config import BAConfig as JBAConfig
from davo_tpu_torch.ba import gn, residuals
from davo_tpu_torch.config import BAConfig

CFG = dict(max_iterations=10, damping=1e-4, huber_delta=1.0, outlier_px=16.0)  # BAConfig's defaults
WINDOWS = range(6)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _window(seed, M=8, N=96, step=5e-4):
    """(poses_cw, points_w, K, observations, mask) as float64 numpy: M
    cameras `step` apart along z (each turned by ~0.1 mrad), 416x128
    images."""
    rng = np.random.default_rng(seed)
    K = np.array([[200.0, 0, 208], [0, 200.0, 64], [0, 0, 1]])
    pts = rng.uniform([-6, -2, 4], [6, 2, 20], size=(N, 3))
    poses_wc = np.stack([_se3_exp_np(np.concatenate([[0, 0, i * step], rng.normal(0, 1e-4, 3)])) for i in range(M)])
    poses_cw = np.linalg.inv(poses_wc)
    pix, z = residuals.project_points(*(torch.as_tensor(a) for a in (poses_cw, pts, K)))
    pix, z = pix.numpy(), z.numpy()
    mask = ((z > 0.1) & (pix[..., 0] >= 0) & (pix[..., 0] <= 415) & (pix[..., 1] >= 0) & (pix[..., 1] <= 127))
    obs = pix + rng.normal(0, 0.5, pix.shape)
    init = poses_cw.copy()
    for i in range(2, M):
        init[i] = _se3_exp_np(rng.normal(0, 2e-3, 6)) @ init[i]
    points = pts * (1 + rng.normal(0, 0.1, (N, 1)))
    return [np.asarray(a, np.float64) for a in (init, points, K, obs, mask)]


def _costs(arrays):
    """Each package's Huber cost before and after each of CFG's
    iterations, in float64."""
    port = gn.BAProblem(*(torch.from_numpy(a) for a in arrays))
    got = [float(gn.ba_cost(port, CFG["huber_delta"]))]
    with jax.enable_x64(True):
        ref = jgn.BAProblem(*(jnp.asarray(a) for a in arrays))
        want = [float(jgn.ba_cost(ref, CFG["huber_delta"]))]
        for _ in range(CFG["max_iterations"]):
            port = gn.ba_iteration(port, BAConfig(**CFG))
            ref = jgn.ba_iteration(ref, JBAConfig(**CFG))
            got.append(float(gn.ba_cost(port, CFG["huber_delta"])))
            want.append(float(jgn.ba_cost(ref, CFG["huber_delta"])))
    return np.array(got), np.array(want)


@pytest.mark.parametrize("seed", WINDOWS)
def test_port_iterates_as_the_reference(seed):
    got, want = _costs(_window(seed))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.array_equal(np.diff(got) > 0, np.diff(want) > 0)


def test_the_damped_steps_raise_the_cost_in_some_windows():
    rising = [seed for seed in WINDOWS if (np.diff(_costs(_window(seed))[1]) > 0).any()]
    assert rising, "no window's cost rose under the reference's steps"
