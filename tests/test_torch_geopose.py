"""The geometric pose head of davo_tpu_torch (`models/geopose.py` and
`pose_head="geo_hybrid"`) against the JAX package (CPU, float32).

Tolerances: the solve's pose vectors within 1e-5 of the reference's on
the same inputs (6 Gauss-Newton iterations of a float32 6x6 system);
against the synthetic world's exact pose 1e-4, as the reference's
`tests/test_geopose.py` holds it; gradients in flow, depth and weight
within 1e-4 of each gradient's largest element against `jax.grad`; the
`tiny` geo_hybrid forward's poses and `pose_geo` within 1e-5, a train
step's loss within 1e-4 relative. The reference runs under `jax.jit`.
"""

import contextlib
import dataclasses
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.cli.main import main as j_cli_main
from davo_tpu.config import Config as JConfig
from davo_tpu.config import TrainConfig as JTrainConfig
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.models.geopose import pose_from_flow as j_pose_from_flow
from davo_tpu.models.geopose import pose_from_flow_pyramid as j_pose_from_flow_pyramid
from davo_tpu.train import loop as jloop
from davo_tpu.train.losses import total_loss as j_total_loss
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.config import Config, ModelConfig, TrainConfig
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.data.snippets import MultiSourceDataset
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.geopose import _skew, pose_from_flow, pose_from_flow_pyramid
from davo_tpu_torch.train import loop

GEO = ModelConfig()  # the solver's defaults: 6 iterations, damping 1e-4, Huber 2.0, step clip 0.5
SOLVER = dict(iters=GEO.geo_pose_iters, damping=GEO.geo_pose_damping, robust_delta=GEO.geo_pose_robust,
              step_clip=GEO.geo_pose_step_clip)
WANDER = dict(trajectory="wander", rot_amp=0.06, n_static=8, texture_mode="procedural", plane_z=30.0)
TINY_GEO = dataclasses.replace(presets.get("tiny").model, pose_head="geo_hybrid")
J_TINY_GEO = dataclasses.replace(jpresets.get("tiny").model, pose_head="geo_hybrid")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return SyntheticSequence(n_frames=8, height=48, width=64, seed=3, **WANDER)


def _pairs(world, idx=(1, 3, 5)):
    """The world's exact flow (target i -> source i-1), depth and pose."""
    flows = np.stack([world.gt_flow(i, i - 1) for i in idx]).astype(np.float32)
    depths = np.stack([world.depth(i) for i in idx]).astype(np.float32)
    poses = np.stack([world.warp_pose(i, i - 1) for i in idx]).astype(np.float32)
    return flows, depths, poses


def _noisy(world, seed):
    """Exact flow and depth with noise and an outlier block, a random
    confidence: inputs on which the robust, clipped solve does work."""
    rng = np.random.default_rng(seed)
    flows, depths, _ = _pairs(world)
    flows = flows + rng.normal(0, 0.3, flows.shape).astype(np.float32)
    flows[:, 5:15, 5:25] += 6.0
    depths = depths * rng.uniform(0.9, 1.1, depths.shape).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, depths.shape).astype(np.float32)
    return flows, depths, weight


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_skew_is_the_cross_product():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    got = torch.einsum("nij,nj->ni", _skew(_t(a)), _t(b)).numpy()
    np.testing.assert_allclose(got, np.cross(a, b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("k_batched", [False, True])
def test_pose_from_flow_matches_reference(world, k_batched):
    flows, depths, weight = _noisy(world, 1)
    K = world.K.astype(np.float32)
    K = np.repeat(K[None], 3, 0) * np.array([1.0, 1.02, 0.98], np.float32)[:, None, None] if k_batched else K
    got = pose_from_flow(_t(flows), _t(depths), _t(K), weight=_t(weight), **SOLVER).numpy()
    want = np.asarray(jax.jit(partial(j_pose_from_flow, **SOLVER))(flows, depths, K, weight))
    assert np.abs(want[:, 3:]).max() > 1e-3  # a pose with rotation to recover
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pose_from_flow_pyramid_matches_reference(world):
    """At the /4 level, flow in level pixels, K (3, 3) rescaled, depth
    strided, as geo_hybrid calls it."""
    flows, depths, _ = _noisy(world, 2)
    level = np.stack([flows[..., 0], flows[..., 1]], -1)[:, ::4, ::4] / 4.0
    K = world.K.astype(np.float32)
    got = pose_from_flow_pyramid(_t(level), _t(depths), _t(K), (48, 64), **SOLVER).numpy()
    want = np.asarray(jax.jit(partial(j_pose_from_flow_pyramid, full_hw=(48, 64), **SOLVER))(level, depths, K))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        pose_from_flow_pyramid(_t(level[:, :11]), _t(depths), _t(K), (48, 64))


def test_exact_on_the_worlds_flow_and_depth(world):
    """The reference's tests/test_geopose.py case: with the world's exact
    flow and depth the solve recovers the warp pose to 1e-4, which pins
    the flow direction, pose direction, intrinsics and Euler layout."""
    flows, depths, poses = _pairs(world)
    got = pose_from_flow(_t(flows), _t(depths), _t(world.K.astype(np.float32)), iters=10, damping=1e-6)
    want = geo.mat_to_pose_vec(_t(poses), "euler")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_gradients_match_jax(world):
    """d(sum c * pose)/d(flow, depth, weight) through the six iterations
    (the solve, the Huber weights, the step clip) against `jax.grad`."""
    flows, depths, weight = _noisy(world, 3)
    flows, depths, weight = flows[:2, ::2, ::2] / 2.0, depths[:2, ::2, ::2], weight[:2, ::2, ::2]
    K = (world.K * np.array([[0.5], [0.5], [1.0]])).astype(np.float32)
    c = np.random.default_rng(4).normal(size=(2, 6)).astype(np.float32)

    def j_objective(f, d, w):
        return jnp.sum(jnp.asarray(c) * j_pose_from_flow(f, d, jnp.asarray(K), w, **SOLVER))

    want = jax.jit(jax.grad(j_objective, argnums=(0, 1, 2)))(flows, depths, weight)
    inputs = [_t(x).clone().requires_grad_() for x in (flows, depths, weight)]
    (_t(c) * pose_from_flow(inputs[0], inputs[1], _t(K), inputs[2], **SOLVER)).sum().backward()
    for name, got, w in zip(("flow", "depth", "weight"), inputs, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)


def _tiny_inputs(seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=(2, 48, 64, 3)).astype(np.float32)
    sources = rng.uniform(size=(2, 2, 48, 64, 3)).astype(np.float32)
    seg = rng.integers(0, 19, (2, 48, 64)).astype(np.int32)
    K = np.array([[40.0, 0.0, 32.0], [0.0, 38.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
    return target, sources, seg, K


def test_geo_hybrid_tiny_forward_matches_reference():
    """Serving (train=False) with the sequence's (3, 3) K: DispNet runs
    on the target, the solve at the /4 level, the conv head a residual
    on it. (The train step below takes the batch's (B, 3, 3) K.)"""
    target, sources, seg, K = _tiny_inputs(5)
    jmodel = JDavoModel(J_TINY_GEO)
    want, params = jax.jit(lambda t, s, g, k: jmodel.init_with_output(
        jax.random.key(0), t, s, seg=g, train=False, K=k))(target, sources, seg, K)
    model = DavoModel(TINY_GEO, device="cpu")
    assert load_flax_params(model, params) == []  # the serving tree holds DispNet
    with torch.no_grad():
        got = model(_t(target), _t(sources), seg=_t(seg), K=_t(K))
    assert got["pose_geo"].shape == (2, 2, 6)
    for key in ("poses", "pose_geo"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5, err_msg=key)
    assert np.abs(np.asarray(want["pose_geo"])).max() > 1e-3


def test_geo_hybrid_train_step_matches_reference():
    """One `tiny` geo_hybrid train step: the batch's (B, 3, 3) K reaches
    the model; loss terms within 1e-4 of the reference's total; the
    backward and the update run and move the parameters."""
    ds = MultiSourceDataset([SyntheticSequence(n_frames=6, height=48, width=64, seed=i) for i in range(2)],
                            batch_size=2, with_seg=True, augment=True, seed=3)
    batch = next(ds.batches(steps=1))
    jcfg = JConfig(model=J_TINY_GEO, train=JTrainConfig(batch_size=2))
    jmodel = JDavoModel(J_TINY_GEO)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b: jmodel.init(jax.random.key(0), b["target"], b["sources"], seg=b["seg"],
                                           train=True, source_disp=True, K=b["K"]))(jb)

    @jax.jit
    def j_metrics(p, b):
        out = jmodel.apply(p, b["target"], b["sources"], seg=b["seg"], train=True, source_disp=True, K=b["K"])
        return j_total_loss(out, b, jcfg.model, jcfg.train, step=jnp.asarray(125, jnp.int32))[1]

    want = {k: float(v) for k, v in j_metrics(params, jb).items()}

    cfg = Config(model=TINY_GEO, train=TrainConfig(batch_size=2))
    state = loop.create_state(cfg, "cpu")
    load_flax_params(state.model, params)
    state.step = 125
    before = [p.detach().clone() for p in state.model.parameters()]
    _, metrics = loop.make_train_step(cfg, "cpu")(state, batch)
    assert metrics.keys() == want.keys()
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), want[key], rtol=0, atol=1e-4 * abs(want["total"]), err_msg=key)
    moved = [not torch.equal(p.detach(), b) for p, b in zip(state.model.parameters(), before)]
    assert all(torch.isfinite(p).all() for p in state.model.parameters()) and sum(moved) > len(moved) // 2


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


class _JitInitDavoModel(JDavoModel):
    """The reference's model with its init under `jax.jit`: the same
    parameters, one compile instead of one per eager op (a minute)."""

    def init(self, rng, *args, **kwargs):
        return jax.jit(lambda r, a, k: super(_JitInitDavoModel, self).init(r, *a, **k))(rng, args, kwargs)


def test_reference_infer_cannot_serve_geo_hybrid(tmp_path, monkeypatch):
    """The reference's `infer` drops the K that `_load_sequence` returns
    (davo_tpu/cli/main.py:332) and builds `make_pose_apply_fn` without it
    (:363), so its geometric head raises. The port's `infer` passes the
    sequence's K: a geo_hybrid checkpoint trained by `cli train` serves."""
    monkeypatch.setattr(jloop, "DavoModel", _JitInitDavoModel)
    with pytest.raises(ValueError, match="requires K"):
        j_cli_main(["infer", "--version", "tiny", "--set", "model.pose_head=geo_hybrid",
                    "--out", str(tmp_path / "ref.txt")])
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "p.txt")
    sets = ["--set", "model.pose_head=geo_hybrid"]
    rc, _ = _run(cli_main, ["train", "--version", "tiny", "--steps", "1", "--worlds", "1", "--world-frames", "6",
                            "--checkpoint-dir", ckpt, "--device", "cpu", *sets])
    assert rc == 0
    rc, _ = _run(cli_main, ["infer", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--out", out,
                            "--device", "cpu", *sets])
    poses = np.loadtxt(out).reshape(-1, 3, 4)
    assert rc == 0 and poses.shape == (32, 3, 4) and np.isfinite(poses).all()
    rc, _ = _run(cli_main, ["depth", "--version", "tiny", "--ckpt", ckpt, "--seq", "1",
                            "--out", str(tmp_path / "depth"), "--device", "cpu", *sets])
    assert rc == 0 and len(list((tmp_path / "depth").iterdir())) == 32
