"""The port's loss terms against the JAX package (CPU, float32, `tiny`
size 48x64, two sources): each value within 1e-5 relative and each input
gradient within 1e-4 of that input's largest gradient magnitude (sums
over every pixel in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.config import TrainConfig as JTrainConfig
from davo_tpu.core import warp as jwarp
from davo_tpu.train import losses as jlosses
from davo_tpu_torch.config import ModelConfig, TrainConfig
from davo_tpu_torch.core import warp
from davo_tpu_torch.train import losses

B, S, H, W = 2, 2, 48, 64
SCALES = 4
FLOW_HW = [(12, 16), (6, 8), (3, 4)]


@pytest.fixture(autouse=True)
def _exact_gather():
    """Both packages on their exact take4 gather (the default)."""
    torch.set_num_threads(1)
    saved = (warp._DEFAULT_GATHER, warp._BAND), (jwarp._DEFAULT_GATHER, jwarp._BAND)
    warp.configure("take4")
    jwarp.configure("take4")
    yield
    warp.configure(*saved[0])
    jwarp.configure(*saved[1])


def _data(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    target = rng.uniform(size=(B, H, W, 3)).astype(f32)
    # Sources close to the target, so the warps compare related images.
    sources = np.clip(target[:, None] + rng.normal(scale=0.1, size=(B, S, H, W, 3)), 0, 1).astype(f32)
    K = np.tile(np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], f32), (B, 1, 1))
    disps = [rng.uniform(0.2, 0.8, (B, H >> s, W >> s, 1)).astype(f32) for s in range(SCALES)]
    disp_src = rng.uniform(0.2, 0.8, (S * B, H, W, 1)).astype(f32)
    poses = np.concatenate(
        [rng.normal(scale=0.2, size=(B, S, 3)), rng.normal(scale=0.02, size=(B, S, 3))], -1
    ).astype(f32)
    flows = [rng.normal(scale=1.0, size=(S, B, h, w, 2)).astype(f32) for h, w in FLOW_HW]
    gt_flow = rng.normal(scale=3.0, size=(B, S, H, W, 2)).astype(f32)
    gt_vec = np.concatenate(
        [rng.normal(scale=0.5, size=(B * S, 3)), rng.normal(scale=0.05, size=(B * S, 3))], -1
    ).astype(f32)
    from davo_tpu.core import geometry as jgeo

    gt_pose = np.asarray(jgeo.pose_vec_to_mat(jnp.asarray(gt_vec))).reshape(B, S, 4, 4)
    return dict(target=target, sources=sources, K=K, disps=disps, disp_src=disp_src,
                poses=poses, flows=flows, gt_flow=gt_flow, gt_pose=gt_pose)


def _pyrs(flows):
    """(S, B, h, w, 2) per level -> per-source fine->coarse pyramids."""
    return [[lv[s] for lv in flows] for s in range(S)]


def _compare(fn_t, fn_j, args, value_rtol=1e-5, grad_tol=1e-4):
    """fn_*(*args) -> scalar; compares value and d/d(each arg)."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    val = fn_t(*ts)
    grads = torch.autograd.grad(val, ts, allow_unused=True)
    jval, jgrads = jax.value_and_grad(fn_j, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args]
    )
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=value_rtol, atol=0)
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        g = np.zeros_like(jg) if g is None else g.numpy()
        np.testing.assert_allclose(g, jg, rtol=0, atol=grad_tol * max(np.abs(jg).max(), 1e-12))
    return float(val), [None if g is None else g.numpy() for g in grads]


@pytest.mark.parametrize(
    "kw",
    [
        dict(masking="border"),
        dict(masking="automin"),
        dict(masking="valid"),
        dict(masking="border", fullres=True),
        dict(masking="border", depth_norm=True, depth_grad_scale=0.5),
    ],
    ids=["border", "automin", "valid", "fullres", "depth_norm_gated"],
)
def test_photometric_loss_matches_reference(kw):
    d = _data(1)
    if kw.get("depth_norm"):
        # Mean-1 depths: scale the translations with them, or points land
        # near z = 0 where the projection's slope amplifies f32 rounding.
        d["poses"][..., :3] *= 0.1
    t_args = {k: torch.from_numpy(d[k]) for k in ("target", "sources", "K")}

    def fn_t(poses, *disps):
        return losses.photometric_loss(list(disps), poses, t_args["target"], t_args["sources"],
                                       t_args["K"], 0.85, **kw)

    def fn_j(poses, *disps):
        return jlosses.photometric_loss(list(disps), poses, jnp.asarray(d["target"]),
                                        jnp.asarray(d["sources"]), jnp.asarray(d["K"]), 0.85, **kw)

    _compare(fn_t, fn_j, [d["poses"], *d["disps"]])


def test_smoothness_loss_matches_reference():
    d = _data(2)
    tgt = d["target"]
    _compare(
        lambda *ds: losses.smoothness_loss(list(ds), torch.from_numpy(tgt)),
        lambda *ds: jlosses.smoothness_loss(list(ds), jnp.asarray(tgt)),
        d["disps"],
    )


@pytest.mark.parametrize("depth_norm, dgs", [(False, 1.0), (True, 0.5)])
def test_geometry_consistency_matches_reference(depth_norm, dgs):
    d = _data(3)
    K = d["K"]
    _compare(
        lambda dt, ds, p: losses.geometry_consistency_loss(
            dt, ds, p, torch.from_numpy(K), depth_grad_scale=dgs, depth_norm=depth_norm),
        lambda dt, ds, p: jlosses.geometry_consistency_loss(
            dt, ds, p, jnp.asarray(K), depth_grad_scale=dgs, depth_norm=depth_norm),
        [d["disps"][0], d["disp_src"], d["poses"]],
    )


@pytest.mark.parametrize("res_mode, masking", [("level", "border"), ("full", "border"), ("level", "valid")])
def test_flow_losses_match_reference(res_mode, masking):
    d = _data(4)
    tgt, src = d["target"], d["sources"]
    _compare(
        lambda *f: losses.flow_losses(_pyrs(f), torch.from_numpy(tgt), torch.from_numpy(src),
                                      0.85, masking=masking, res_mode=res_mode),
        lambda *f: jlosses.flow_losses(_pyrs(f), jnp.asarray(tgt), jnp.asarray(src),
                                       0.85, masking=masking, res_mode=res_mode),
        d["flows"],
    )


def test_supervision_losses_match_reference():
    d = _data(5)
    gt_pose, gt_flow = d["gt_pose"], d["gt_flow"]
    _compare(
        lambda p: losses.pose_supervision_loss(p, torch.from_numpy(gt_pose), 10.0),
        lambda p: jlosses.pose_supervision_loss(p, jnp.asarray(gt_pose), 10.0),
        [d["poses"]],
    )
    _compare(
        lambda *f: losses.flow_supervision_loss(_pyrs(f), torch.from_numpy(gt_flow)),
        lambda *f: jlosses.flow_supervision_loss(_pyrs(f), jnp.asarray(gt_flow)),
        d["flows"],
    )


@pytest.mark.parametrize("step", [0, 125])
def test_total_loss_matches_reference_with_the_warmup(step):
    """Every term on (pose and flow supervision included). At step 0 the
    warm-up gate sends no photometric or geometry gradient into depth:
    the disparity gradients are the smoothness term's alone."""
    d = _data(6)
    tkw = dict(pose_supervision_weight=0.3, flow_supervision_weight=0.2)
    tcfg, jtcfg = TrainConfig(**tkw), JTrainConfig(**tkw)
    mcfg = ModelConfig()
    batch = {k: d[k] for k in ("target", "sources", "K", "gt_pose", "gt_flow")}
    n = len(d["disps"])

    def outputs(poses, disp_src, *rest):
        disps, flows = list(rest[:n]), rest[n:]
        return dict(disp=disps, disp_src=[disp_src], poses=poses, flows=_pyrs(flows))

    metrics = {}

    def fn_t(*args):
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        loss, metrics["port"] = losses.total_loss(outputs(*args), tb, mcfg, tcfg, step=step)
        return loss

    def fn_j(*args):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jlosses.total_loss(outputs(*args), jb, None, jtcfg, step=jnp.asarray(step, jnp.int32))[0]

    args = [d["poses"], d["disp_src"], *d["disps"], *d["flows"]]
    _, grads = _compare(fn_t, fn_j, args)
    _, ref = jlosses.total_loss(
        outputs(*[jnp.asarray(a) for a in args]), {k: jnp.asarray(v) for k, v in batch.items()},
        None, jtcfg, step=jnp.asarray(step, jnp.int32),
    )
    port = metrics["port"]
    assert set(port) == set(ref) == {"photo", "smooth", "geo_consistency", "flow", "flow_sup",
                                     "pose_sup", "total"}
    for key in port:
        np.testing.assert_allclose(float(port[key]), float(ref[key]), rtol=1e-5, err_msg=key)
    # Source disparities reach the loss only through the geometry term,
    # which the warm-up gate closes at step 0.
    assert np.any(grads[1]) == (step > 0)


def test_depth_gate_keeps_the_value():
    x = torch.linspace(0.5, 2.0, 5, requires_grad=True)
    y = losses._gate_depth(x, 0.25)
    assert torch.equal(y, x.detach())
    (g,) = torch.autograd.grad(y.sum(), (x,))
    assert torch.allclose(g, torch.full_like(g, 0.25))
    assert losses._gate_depth(x, 1.0) is x
