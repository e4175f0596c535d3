"""geo_hybrid's Gauss-Newton solve in float32 against float64: the port
against the reference (CPU).

The solve's inputs are the port's own, from chip_smoke.py phase 13's
kind of run: the finest flow level, the DispNet depth and the camera K of
a `davo` geo_hybrid forward in float32 on a seeded synthetic world, here
at 128x416 (B=2, seed 3, the preset's iters=6, damping=1e-4,
robust_delta=2, step_clip=0.5). On those inputs the reference solves in
float32 under `jax.jit` and op by op, and in float64 (`jax.enable_x64`
with its float32 read as float64); the port in float32 and in float64
(chip_smoke.py's `_float64_program`, whose record of the dtypes returned
shows the run float64 throughout). The port's float32 solve must land no
further from the reference's float64 solve than the reference's own
float32 solve does (measured 6.1e-5 against 2.8e-4 of the largest pose
element, 2.8e-4 op by op): so the card-against-CPU gap of phase 13
(4.65e-5) is float32's own, of the size of the reference's spread between
its two ways of running (1.5e-5 here), not a fault of the port's solve.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from davo_tpu.models.geopose import pose_from_flow_pyramid as j_pose_from_flow_pyramid
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models import davo, presets
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.geopose import pose_from_flow_pyramid

CFG = presets.with_overrides("davo", compute_dtype="float32", pose_head="geo_hybrid").model
B, SEED = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@contextlib.contextmanager
def _reference_float64():
    """x64 on, and `jnp.float32` read as float64 while open."""
    real = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = real


@pytest.fixture(scope="module")
def solve_inputs():
    """(flow, depth, K, full_hw) and the solve's keywords, as the port's
    float32 forward hands them to `pose_from_flow_pyramid`, and the pose
    it returned."""
    world = SyntheticSequence(n_frames=B + 1, height=CFG.img_height, width=CFG.img_width, seed=SEED)
    x = torch.from_numpy(np.stack([world.frame(i + 1) for i in range(B)]))
    y = torch.from_numpy(np.stack([world.frame(i) for i in range(B)]))[:, None]
    s = torch.from_numpy(np.stack([world.seg(i + 1) for i in range(B)]).astype(np.int64))
    K = torch.from_numpy(np.asarray(world.K, np.float32))
    model = DavoModel(CFG, device="cpu", seed=SEED).eval()
    calls = []

    def recorded(*args, **kwargs):
        out = pose_from_flow_pyramid(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    real = davo.pose_from_flow_pyramid
    davo.pose_from_flow_pyramid = recorded
    try:
        with torch.inference_mode():
            model(x, y, seg=s, K=K)
    finally:
        davo.pose_from_flow_pyramid = real
    (args, kwargs, out), = calls
    return args, kwargs, out


def _rel(got, exact):
    got, exact = np.asarray(got, np.float64), np.asarray(exact, np.float64)
    return float(np.abs(got - exact).max() / np.abs(exact).max())


def test_port_solve_lands_no_further_from_float64_than_the_reference(solve_inputs):
    (flow, depth, K, full_hw), kwargs, port32 = solve_inputs
    assert kwargs == dict(iters=6, damping=1e-4, robust_delta=2.0, step_clip=0.5)
    arrays = [np.asarray(t) for t in (flow, depth, K)]

    def reference(*a):
        return j_pose_from_flow_pyramid(*a, full_hw, **kwargs)

    ref32_jit = jax.jit(reference)(*[jnp.asarray(a) for a in arrays])
    ref32_eager = reference(*[jnp.asarray(a) for a in arrays])
    with _reference_float64():
        ref64 = jax.jit(reference)(*[jnp.asarray(a.astype(np.float64)) for a in arrays])
        assert ref64.dtype == jnp.float64
    with chip_smoke._float64_program(torch) as seen:
        seen.clear()
        port64 = pose_from_flow_pyramid(*(t.double() for t in (flow, depth, K)), full_hw, **kwargs)
    assert seen == {torch.float64}, seen
    ref64 = np.asarray(ref64)
    d = {"reference float32 jit": _rel(ref32_jit, ref64), "reference float32 op by op": _rel(ref32_eager, ref64),
         "port float32": _rel(port32, ref64), "port float64": _rel(port64, ref64),
         "reference jit vs op by op": _rel(ref32_jit, ref32_eager)}
    print(f"geo_hybrid solve at {full_hw}, B={flow.shape[0]}, of the largest pose element from the reference's "
          f"float64: {d}")
    assert d["port float64"] <= 1e-9
    assert d["port float32"] <= d["reference float32 jit"]
