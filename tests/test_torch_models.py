"""davo_tpu_torch models against the JAX reference (CPU; float32, and bf16 rounding).

Each module gets the reference's parameters through the Flax -> torch
converter and the same numpy inputs; outputs must agree within the
stated tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models import presets as jpresets
from davo_tpu.models.attention import RegionAttention as JRegionAttention
from davo_tpu.models.attention import region_weight_map as j_region_weight_map
from davo_tpu.models.attention import seg_to_onehot as j_seg_to_onehot
from davo_tpu.models.common import ConvBlock as JConvBlock
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.models.dispnet import DispNet as JDispNet
from davo_tpu.models.dispnet import depth_to_disp as j_depth_to_disp
from davo_tpu.models.dispnet import disp_to_depth as j_disp_to_depth
from davo_tpu.models.flownet import FeaturePyramid as JFeaturePyramid
from davo_tpu.models.flownet import FlowNetLite as JFlowNetLite
from davo_tpu.models.posenet import PoseNet as JPoseNet
from davo_tpu_torch.convert import flax_to_state_dict, load_flax_params
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.attention import RegionAttention, region_weight_map
from davo_tpu_torch.models.common import ConvBlock
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.dispnet import DispNet, depth_to_disp, disp_to_depth
from davo_tpu_torch.models.flownet import FeaturePyramid, FlowNetLite
from davo_tpu_torch.models.posenet import PoseNet

TINY = presets.get("tiny").model
J_TINY = jpresets.get("tiny").model
H, W = TINY.img_height, TINY.img_width


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _seg(seed, b, h, w):
    return np.random.default_rng(seed).integers(0, 19, size=(b, h, w)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def _davo_pair(jcfg, cfg, target, sources, seg):
    jmodel = JDavoModel(jcfg)
    params = jmodel.init(
        jax.random.key(0), jnp.asarray(target), jnp.asarray(sources),
        seg=jnp.asarray(seg), train=False,
    )
    model = DavoModel(cfg, device="cpu", seed=1)
    assert load_flax_params(model, params) == []
    return jmodel, params, model


def test_feature_pyramid_matches_reference():
    img = _images(0, 2, H, W, 3)
    jnet = JFeaturePyramid(J_TINY)
    params = jnet.init(jax.random.key(1), jnp.asarray(img))
    net = FeaturePyramid(TINY)
    load_flax_params(net, params)
    got = net(_t(img))
    want = jnet.apply(params, jnp.asarray(img))
    assert [tuple(g.shape) for g in got] == [(2, 24, 32, 16), (2, 12, 16, 32), (2, 6, 8, 64)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("feat_channels, bottleneck", [(0, 0), (8, 0), (0, 16)])
def test_flownet_matches_reference(feat_channels, bottleneck):
    kw = dict(costvol_feat_channels=feat_channels, flow_est_bottleneck=bottleneck)
    jcfg, cfg = dataclasses.replace(J_TINY, **kw), dataclasses.replace(TINY, **kw)
    a, b = _images(2, 2, H, W, 3), _images(3, 2, H, W, 3)
    jnet = JFlowNetLite(jcfg)
    params = jnet.init(jax.random.key(2), jnp.asarray(a), jnp.asarray(b))
    net = FlowNetLite(cfg)
    load_flax_params(net, params)
    with torch.no_grad():
        got = net(_t(a), _t(b))
    want = jnet.apply(params, jnp.asarray(a), jnp.asarray(b))
    assert [tuple(g.shape) for g in got] == [(2, 12, 16, 2), (2, 6, 8, 2)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    _close(
        FlowNetLite.full_res_flow(got[0], H, W),
        JFlowNetLite.full_res_flow(want[0], H, W),
        1e-4,
    )


def test_region_attention_and_weight_map_match_reference():
    flow = np.random.default_rng(4).normal(scale=2.0, size=(3, H, W, 2)).astype(np.float32)
    jnet = JRegionAttention(J_TINY)
    params = jnet.init(jax.random.key(3), jnp.asarray(flow))
    net = RegionAttention(TINY, 2)
    load_flax_params(net, params)
    with torch.no_grad():
        got = net(_t(flow))
    want = jnet.apply(params, jnp.asarray(flow))
    _close(got, want, 1e-4)
    seg = _seg(5, 3, H, W)
    seg[0, :3, :5] = -1  # out-of-range labels: an all-zero one-hot row
    seg[1, -2:, -4:] = 19
    onehot = j_seg_to_onehot(jnp.asarray(seg), 19)
    # (5, 7) divides nothing: the full-resolution map, then the
    # antialiased resize, as the reference.
    for hw in [(6, 8), (12, 16), (1, 4), (H, W), (5, 7)]:
        _close(
            region_weight_map(got, _t(seg), 19, hw),
            j_region_weight_map(want, onehot, hw),
            1e-4,
        )


def test_posenet_matches_reference():
    t, s = _images(6, 2, H, W, 3), _images(7, 2, H, W, 3)
    extra = np.random.default_rng(8).normal(size=(2, H, W, 3)).astype(np.float32)
    wmap = np.random.default_rng(9).uniform(size=(2, 6, 8, 1)).astype(np.float32)
    jnet = JPoseNet(J_TINY)
    args = (jnp.asarray(t), jnp.asarray(s), jnp.asarray(extra))
    params = jnet.init(jax.random.key(4), *args)
    net = PoseNet(TINY, extra_channels=3)
    load_flax_params(net, params)
    with torch.no_grad():
        for fn, jfn in [(None, None), (lambda hw: _t(wmap), lambda hw: jnp.asarray(wmap))]:
            got = net(_t(t), _t(s), _t(extra), region_weight_fn=fn)
            want = jnet.apply(params, *args, region_weight_fn=jfn)
            _close(got, want, 1e-4)


@pytest.mark.parametrize("cue", ["flow", "flow_fb"])
def test_davo_tiny_matches_reference(cue):
    """The whole slice in f32 at `tiny`, two sources (batch folding and
    the direction plane), with seg-driven region attention."""
    jcfg = dataclasses.replace(J_TINY, attention_cue=cue)
    cfg = dataclasses.replace(TINY, attention_cue=cue)
    target, sources = _images(10, 2, H, W, 3), _images(11, 2, 2, H, W, 3)
    seg = _seg(12, 2, H, W)
    jmodel, params, model = _davo_pair(jcfg, cfg, target, sources, seg)
    want = jmodel.apply(
        params, jnp.asarray(target), jnp.asarray(sources), seg=jnp.asarray(seg), train=False
    )
    with torch.no_grad():
        got = model(_t(target), _t(sources), seg=_t(seg))
    assert got["poses"].shape == (2, 2, 6)
    _close(got["poses"], want["poses"], 1e-4)
    _close(got["attn"], want["attn"], 1e-4)
    for src_got, src_want in zip(got["flows"], want["flows"]):
        for g, w in zip(src_got, src_want):
            _close(g, w, 1e-3)


@pytest.mark.parametrize(
    "kernel, stride, height, width, cin, cout",
    [(7, 2, 32, 52, 9, 16), (5, 2, 16, 26, 16, 32), (3, 2, 14, 13, 32, 64),
     (3, 1, 13, 26, 24, 32), (1, 1, 8, 13, 16, 8)],
)
def test_conv_block_bf16_rounds_as_reference(kernel, stride, height, width, cin, cout):
    """bf16 placement: input and weights cast down, the conv's output
    rounded to bf16, then the bias added in bf16, as Flax does. Both
    sides accumulate in f32, so the outputs agree bit for bit except
    where the summation order flips a rounding. The same block run in
    f32 and rounded once at the end must fail the criterion."""
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.uniform(-1, 1, size=(2, height, width, cin)).astype(np.float32)
    jblock = JConvBlock(cout, kernel, stride, jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.key(0), jnp.asarray(x)))
    params["params"]["Conv_0"]["bias"] = rng.normal(scale=0.5, size=cout).astype(np.float32)
    want = np.asarray(jblock.apply(params, jnp.asarray(x)).astype(jnp.float32))
    block = ConvBlock(cin, cout, kernel, stride, torch.bfloat16)
    load_flax_params(block, params)
    with torch.no_grad():
        got = block(_t(x)).float().numpy()
    assert got.shape == want.shape
    assert np.mean(got != want) <= 1e-3
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()  # one bf16 ulp
    f32_block = ConvBlock(cin, cout, kernel, stride, torch.float32)
    load_flax_params(f32_block, params)
    with torch.no_grad():
        rounded_once = f32_block(_t(x)).bfloat16().float().numpy()
    assert np.mean(rounded_once != want) > 0.05


def test_davo_tiny_bf16_follows_reference_rounding():
    """The whole tiny forward in bf16: rounding flips make a bit-for-bit
    match impossible past the first layers, so the criterion is
    statistical. Summed over seeds, the port's gap to the reference's
    bf16 poses must be well under the reference's own bf16-to-f32 gap
    (measured: 0.15 of it); a port that rounded elsewhere, or ran in
    f32, would sit near 1."""
    j32 = J_TINY
    j16 = dataclasses.replace(J_TINY, compute_dtype="bfloat16")
    port16 = dataclasses.replace(TINY, compute_dtype="bfloat16")

    def poses(cfg):
        return jax.jit(
            lambda p, t, s, g: JDavoModel(cfg).apply(p, t, s, seg=g, train=False)["poses"]
        )

    init = jax.jit(lambda k, t, s, g: JDavoModel(j32).init(k, t, s, seg=g, train=False))
    apply16, apply32 = poses(j16), poses(j32)
    gap, reference_gap = 0.0, 0.0
    for seed in range(3):
        target, sources = _images(20 + seed, 2, H, W, 3), _images(30 + seed, 2, 1, H, W, 3)
        seg = _seg(40 + seed, 2, H, W)
        args = (jnp.asarray(target), jnp.asarray(sources), jnp.asarray(seg))
        params = init(jax.random.key(seed), *args)
        want16, want32 = np.asarray(apply16(params, *args)), np.asarray(apply32(params, *args))
        model = DavoModel(port16, device="cpu")
        load_flax_params(model, params)
        with torch.no_grad():
            got = model(_t(target), _t(sources), seg=_t(seg))["poses"].numpy()
        gap += np.abs(got - want16).max()
        reference_gap += np.abs(want16 - want32).max()
    assert reference_gap > 0
    assert gap <= 0.5 * reference_gap


FAST_KW = dict(img_height=64, img_width=128, compute_dtype="float32")


@pytest.fixture(scope="module")
def davo_fast():
    """davo-fast's widths at 64x128 in f32: inputs, reference model and
    parameters, and the port with those parameters loaded."""
    jcfg = jpresets.with_overrides("davo-fast", **FAST_KW).model
    cfg = presets.with_overrides("davo-fast", **FAST_KW).model
    target, sources = _images(13, 2, 64, 128, 3), _images(14, 2, 1, 64, 128, 3)
    seg = _seg(15, 2, 64, 128)
    return (target, sources, seg) + _davo_pair(jcfg, cfg, target, sources, seg)


def test_davo_fast_widths_match_reference(davo_fast):
    """davo-fast's widths (8-ch correlation projection, search 3, seven
    pose layers) at 64x128 in f32: poses within 1e-4 of the largest."""
    target, sources, seg, jmodel, params, model = davo_fast
    want = np.asarray(
        jmodel.apply(
            params, jnp.asarray(target), jnp.asarray(sources), seg=jnp.asarray(seg),
            train=False,
        )["poses"]
    )
    with torch.no_grad():
        got = model(_t(target), _t(sources), seg=_t(seg))["poses"].numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_davo_attention_none_and_flow_match_reference():
    for attention in ("none", "flow"):
        jcfg = dataclasses.replace(J_TINY, attention=attention)
        cfg = dataclasses.replace(TINY, attention=attention)
        target, sources = _images(16, 2, H, W, 3), _images(17, 2, 1, H, W, 3)
        jmodel = JDavoModel(jcfg)
        params = jmodel.init(
            jax.random.key(5), jnp.asarray(target), jnp.asarray(sources), train=False
        )
        model = DavoModel(cfg, device="cpu")
        load_flax_params(model, params)
        want = jmodel.apply(params, jnp.asarray(target), jnp.asarray(sources), train=False)
        with torch.no_grad():
            got = model(_t(target), _t(sources))
        _close(got["poses"], want["poses"], 1e-4)
        assert ("flows" in got) == (attention == "flow")


def test_converter_maps_every_leaf(davo_fast):
    params = davo_fast[4]
    leaves = jax.tree_util.tree_leaves(params)
    state, skipped = flax_to_state_dict(params)
    model = DavoModel(presets.with_overrides("davo-fast", **FAST_KW).model, device="cpu")
    assert skipped == []
    assert len(state) == len(leaves) == len(model.state_dict()) == 58
    assert sum(v.numel() for v in state.values()) == sum(
        p.numel() for p in model.parameters()
    )
    sd = model.state_dict()
    for key, value in state.items():
        assert value.shape == sd[key].shape, key
    pose_head = params["params"]["posenet"]["head"]["pose_head"]["kernel"]
    np.testing.assert_array_equal(
        state["posenet.head.pose_head.weight"].numpy(),
        np.asarray(pose_head).transpose(3, 2, 0, 1),
    )
    fc0 = params["params"]["attn"]["fc0"]["kernel"]
    np.testing.assert_array_equal(state["attn.fc0.weight"].numpy(), np.asarray(fc0).T)
    # Round trip: loading the converted tree gives back the same tensors.
    load_flax_params(model, params)
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_converter_rejects_missing_and_extra_keys_and_skips_dispnet():
    """Missing, unexpected and misshapen keys raise. DispNet is no longer
    skipped: a `dispnet` subtree is loaded like any other, so one that
    the module has no place for is an unexpected key."""
    model = FeaturePyramid(TINY)
    params = JFeaturePyramid(J_TINY).init(jax.random.key(7), jnp.zeros((1, H, W, 3)))
    tree = jax.tree_util.tree_map(np.asarray, dict(params["params"]))
    missing = {k: v for k, v in tree.items() if k != "feat2b"}
    with pytest.raises(KeyError, match="feat2b"):
        load_flax_params(model, missing)
    extra = dict(tree, feat9a={"Conv_0": tree["feat0a"]["Conv_0"]})
    with pytest.raises(KeyError, match="feat9a"):
        load_flax_params(model, extra)
    bad = dict(tree, feat0a={"Conv_0": tree["feat1a"]["Conv_0"]})
    with pytest.raises(ValueError, match="feat0a"):
        load_flax_params(model, bad)
    with_disp = dict(tree, dispnet={"enc0": {"Conv_0": {"kernel": np.zeros((7, 7, 3, 8))}}})
    with pytest.raises(KeyError, match="dispnet.enc0"):
        load_flax_params(model, with_disp)


def _train_init(jcfg, target, sources, seg):
    """The reference's training init (train=True, source disparities):
    its tree holds the DispNet subtree."""
    return JDavoModel(jcfg).init(
        jax.random.key(0), jnp.asarray(target), jnp.asarray(sources), seg=jnp.asarray(seg),
        train=True, source_disp=True,
    )


def test_converter_loads_the_dispnet_subtree_and_rejects_a_stray_key():
    target, sources, seg = _images(50, 2, H, W, 3), _images(51, 2, 2, H, W, 3), _seg(52, 2, H, W)
    params = jax.tree_util.tree_map(np.asarray, _train_init(J_TINY, target, sources, seg))
    model = DavoModel(TINY, device="cpu", dispnet=True)
    assert load_flax_params(model, params) == []
    state, _ = flax_to_state_dict(params)
    assert any(k.startswith("dispnet.disp0.") for k in state)
    assert len(state) == len(model.state_dict())
    stray = jax.tree_util.tree_map(lambda x: x, params)
    stray["params"]["dispnet"]["disp9"] = {"kernel": np.zeros((3, 3, 16, 1)), "bias": np.zeros(1)}
    with pytest.raises(KeyError, match="dispnet.disp9"):
        load_flax_params(model, stray)
    with pytest.raises(KeyError, match="dispnet"):
        load_flax_params(DavoModel(TINY, device="cpu"), params)


@pytest.mark.parametrize("preset", ["tiny", "davo"])
def test_dispnet_matches_reference(preset):
    """DispNet at `tiny` and at `davo`'s widths (seven levels, 32..512
    channels) on 64x96 in f32: disparities within 1e-5."""
    jcfg = jpresets.with_overrides(preset, compute_dtype="float32").model
    cfg = presets.with_overrides(preset, compute_dtype="float32").model
    img = _images(53, 2, 64, 96, 3)
    jnet = JDispNet(jcfg)
    params = jnet.init(jax.random.key(8), jnp.asarray(img))
    net = DispNet(cfg)
    load_flax_params(net, params)
    with torch.no_grad():
        got = net(_t(img))
    want = jnet.apply(params, jnp.asarray(img))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert tuple(got[0].shape) == (2, 64, 96, 1)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    depth = np.linspace(0.6, 90.0, 7, dtype=np.float32)
    _close(disp_to_depth(_t(depth / 100.0)), j_disp_to_depth(jnp.asarray(depth / 100.0)), 1e-4)
    _close(depth_to_disp(_t(depth)), j_depth_to_disp(jnp.asarray(depth)), 1e-6)


def test_davo_train_forward_matches_reference():
    """train=True with source disparities at `tiny`: one DispNet pass
    over target and sources, split at row B, as the reference."""
    target, sources, seg = _images(54, 2, H, W, 3), _images(55, 2, 2, H, W, 3), _seg(56, 2, H, W)
    params = _train_init(J_TINY, target, sources, seg)
    model = DavoModel(TINY, device="cpu", dispnet=True)
    load_flax_params(model, params)
    want = JDavoModel(J_TINY).apply(
        params, jnp.asarray(target), jnp.asarray(sources), seg=jnp.asarray(seg),
        train=True, source_disp=True,
    )
    with torch.no_grad():
        got = model(_t(target), _t(sources), seg=_t(seg), train=True, source_disp=True)
    assert set(got) == set(want)
    _close(got["poses"], want["poses"], 1e-4)
    for key in ("disp", "disp_src"):
        assert len(got[key]) == len(want[key]) == 3  # tiny's three decoder levels
        for g, w in zip(got[key], want[key]):
            _close(g, w, 1e-5)
    assert got["disp_src"][0].shape == (4, H, W, 1)


def test_init_mirrors_flax_defaults():
    model = DavoModel(TINY, device="cpu", seed=3)
    w = model.posenet.encoder.enc1.Conv_0.weight.detach()  # fan_in = 8 * 5 * 5
    std = float(w.std())
    assert abs(std - (1 / 200) ** 0.5) < 0.2 * (1 / 200) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 200) ** 0.5 / 0.87962566103423978 + 1e-6
    assert all(not b.any() for n, b in model.state_dict().items() if n.endswith("bias"))
    again = DavoModel(TINY, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize(
    "override", [{"pose_head": "geo_hybrid"}, {"pose_head": "geo_hybrid", "attention": "none"}]
)
def test_unported_options_are_refused(override):
    """geo_hybrid and s2d_first_conv were refused until they were ported
    (tests/test_torch_geopose.py, tests/test_torch_options.py); what the
    reference refuses the port still refuses: the geometric head without
    the camera K, or without the flow net."""
    model = DavoModel(dataclasses.replace(TINY, **override), device="cpu")
    x = torch.zeros(1, H, W, 3)
    with pytest.raises(ValueError, match="requires K" if "attention" not in override else "flow net"):
        with torch.no_grad():
            model(x, x[:, None])


def _train_forward_loss(model, seed):
    target, sources = _t(_images(seed, 2, H, W, 3)), _t(_images(seed + 1, 2, 1, H, W, 3))
    out = model(target, sources, seg=_t(_seg(seed + 2, 2, H, W)), train=True, source_disp=True)
    return out["poses"].square().sum() + sum(d.square().sum() for d in out["disp"] + out["disp_src"])


@pytest.mark.parametrize("flag", [
    "fuse_estimator_train", "fuse_flow_level_train", "fuse_pyramid_train", "fuse_attention_train",
    "fuse_pose_encoder_train", "fuse_disp_encoder_train", "fuse_disp_encoder",
])
def test_fused_flags_build_and_run_the_train_forward(flag):
    """Each fused flag the training path may reach builds on the CPU. A
    `_train` flag backpropagates into every parameter the unfused model
    reaches, with the same gradients (f32); the serving `fuse_disp_encoder`
    runs the train forward under no_grad, as the same function, and
    raises under autograd."""
    plain = DavoModel(TINY, device="cpu", seed=4, dispnet=True)
    fused = DavoModel(dataclasses.replace(TINY, **{flag: True}), device="cpu", seed=4, dispnet=True)
    if not flag.endswith("_train"):
        with torch.no_grad():
            np.testing.assert_allclose(_train_forward_loss(fused, 80), _train_forward_loss(plain, 80), rtol=1e-5)
        with pytest.raises(RuntimeError, match="serving-only"):
            _train_forward_loss(fused, 80)
        return
    for model in (plain, fused):
        _train_forward_loss(model, 80).backward()
    for (name, p), q in zip(plain.named_parameters(), fused.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            scale = float(p.grad.abs().max())
            np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), rtol=0, atol=1e-4 * scale, err_msg=name)


def test_strided_train_flag_refuses_bf16_dot():
    """The reference's strided backward has no bf16_dot mode (its dtype
    table at rowconv.py:1435 lacks it): a `_train` flag with
    fuse_compute="bf16_dot" raises under autograd rather than running
    another function; under no_grad it runs the serving kernel."""
    cfg = dataclasses.replace(TINY, fuse_pose_encoder_train=True, fuse_compute="bf16_dot")
    model = DavoModel(cfg, device="cpu", dispnet=True)
    with torch.no_grad():
        assert torch.isfinite(_train_forward_loss(model, 81))
    with pytest.raises(ValueError, match="bf16_dot"):
        _train_forward_loss(model, 81)


def test_train_forward_is_refused():
    """The training forward needs DispNet: a model built without it
    refuses train=True, and an unknown DispNet encoder is refused (the
    resnet one is ported: tests/test_torch_options.py)."""
    model = DavoModel(TINY, device="cpu")
    x = torch.zeros(1, H, W, 3)
    with pytest.raises(ValueError, match="train"):
        model(x, x[:, None], train=True)
    with pytest.raises(ValueError, match="disp_encoder"):
        DavoModel(dataclasses.replace(TINY, disp_encoder="vgg"), device="cpu", dispnet=True)


# ------------------------------------------------------ fused serving path

SERVING_FLAGS = dict(
    fuse_pyramid=True, fuse_flow_level=True, fuse_attention=True, fuse_pose_encoder=True
)


def _fused(cfg, **flags):
    return dataclasses.replace(cfg, **(flags or SERVING_FLAGS))


def _module_pair(jcls, cls, cfg, jcfg, port_args, key, *inputs):
    """(reference fused output, port fused output, port unfused output)
    on one converted tree: the fused modules read the unfused parameters."""
    jinputs = [jnp.asarray(a) for a in inputs]
    params = jcls(jcfg).init(jax.random.key(key), *jinputs)
    want = jcls(_fused(jcfg)).apply(params, *jinputs)
    fused, plain = cls(_fused(cfg), *port_args), cls(cfg, *port_args)
    load_flax_params(fused, params)
    load_flax_params(plain, params)
    with torch.no_grad():
        return want, fused(*map(_t, inputs)), plain(*map(_t, inputs))


def _close_all(got, want, atol):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.float(), np.asarray(w, np.float32), atol)


@pytest.mark.parametrize("height", [48, 50])
def test_fused_feature_pyramid_matches_reference(height):
    """48x64 fuses the whole ladder (taps at layers 1, 3, 5); at 50 rows
    the second stride-2 layer sees 25, so the reference and the port run
    the unfused ladder."""
    img = _images(60, 2, height, W, 3)
    want, fused, plain = _module_pair(JFeaturePyramid, FeaturePyramid, TINY, J_TINY, (), 9, img)
    _close_all(fused, want, 1e-5)
    _close_all(fused, plain, 1e-5)


@pytest.mark.parametrize("flags", [SERVING_FLAGS, {"fuse_estimator": True}])
def test_fused_flownet_matches_reference(flags):
    """The fused flow level (two per forward at tiny, with the pyramid
    fused), and the fused estimator chain (cost volume unfused)."""
    jcfg = dataclasses.replace(J_TINY, costvol_feat_channels=8, **flags)
    cfg = dataclasses.replace(TINY, costvol_feat_channels=8, **flags)
    a, b = _images(61, 2, H, W, 3), _images(62, 2, H, W, 3)
    params = JFlowNetLite(dataclasses.replace(J_TINY, costvol_feat_channels=8)).init(
        jax.random.key(10), jnp.asarray(a), jnp.asarray(b)
    )
    want = JFlowNetLite(jcfg).apply(params, jnp.asarray(a), jnp.asarray(b))
    fused = FlowNetLite(cfg)
    plain = FlowNetLite(dataclasses.replace(TINY, costvol_feat_channels=8))
    load_flax_params(fused, params)
    load_flax_params(plain, params)
    with torch.no_grad():
        got, unfused = fused(_t(a), _t(b)), plain(_t(a), _t(b))
    _close_all(got, want, 1e-4)
    _close_all(got, unfused, 1e-4)


@pytest.mark.parametrize("height", [48, 36])
def test_fused_posenet_matches_reference(height):
    """tiny's three stride-2 pose layers: all fused at 48x64 (a full
    prefix); at 36x64 the third sees 9 rows, so two fuse and one runs as
    a `ConvBlock` (a partial prefix)."""
    t, s = _images(63, 2, height, W, 3), _images(64, 2, height, W, 3)
    extra = np.random.default_rng(65).normal(size=(2, height, W, 3)).astype(np.float32)
    want, fused, plain = _module_pair(JPoseNet, PoseNet, TINY, J_TINY, (3,), 11, t, s, extra)
    _close_all(fused, want, 1e-5)
    _close_all(fused, plain, 1e-5)


def test_fused_region_attention_matches_reference():
    flow = np.random.default_rng(66).normal(scale=2.0, size=(3, H, W, 2)).astype(np.float32)
    want, fused, plain = _module_pair(JRegionAttention, RegionAttention, TINY, J_TINY, (2,), 12, flow)
    _close_all(fused, want, 1e-5)
    _close_all(fused, plain, 1e-5)


def _poses_and_attn_match(jcfg, cfg, hw, seed, tol=1e-4):
    """The fused DavoModel against the reference's fused DavoModel, and
    against the port's unfused model, on one converted tree: poses and
    attention within `tol` of their largest element."""
    h, w = hw
    target, sources = _images(seed, 2, h, w, 3), _images(seed + 1, 2, 1, h, w, 3)
    seg = _seg(seed + 2, 2, h, w)
    jmodel, params, plain = _davo_pair(jcfg, cfg, target, sources, seg)
    args = (jnp.asarray(target), jnp.asarray(sources))
    want = JDavoModel(_fused(jcfg)).apply(params, *args, seg=jnp.asarray(seg), train=False)
    fused = DavoModel(_fused(cfg), device="cpu")
    load_flax_params(fused, params)
    with torch.no_grad():
        got = fused(_t(target), _t(sources), seg=_t(seg))
        unfused = plain(_t(target), _t(sources), seg=_t(seg))
    for key in ("poses", "attn"):
        scale = np.abs(np.asarray(want[key])).max()
        assert scale > 0
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() <= tol * scale, key
        assert np.abs(got[key].numpy() - unfused[key].numpy()).max() <= tol * scale, key


def test_davo_all_fused_serving_matches_reference():
    """The four serving flags at the configuration of
    tests/test_models.py::TestDavoModel::test_all_fused_serving_matches_xla."""
    kw = dict(img_height=64, img_width=96, pose_channels=(8, 12, 16, 16),
              disp_channels=(8, 12, 16, 16), flow_levels=3, flow_search_range=2,
              attention="flow_seg", compute_dtype="float32")
    jcfg = dataclasses.replace(jpresets.get("tiny").model, pose_scale=0.01, **kw)
    cfg = dataclasses.replace(TINY, pose_scale=0.01, **kw)
    _poses_and_attn_match(jcfg, cfg, (64, 96), 70)


def test_davo_fast_widths_all_fused_match_reference():
    """davo-fast's widths at 64x208 in f32 with the four serving flags:
    the pose encoder fuses 4 of its 7 layers (the fifth sees 4x13) and
    runs 3 as `ConvBlock`s."""
    kw = dict(img_height=64, img_width=208, compute_dtype="float32")
    jcfg = jpresets.with_overrides("davo-fast", **kw).model
    cfg = presets.with_overrides("davo-fast", **kw).model
    _poses_and_attn_match(jcfg, cfg, (64, 208), 73)


def test_davo_fused_estimator_matches_reference():
    jcfg = dataclasses.replace(J_TINY, costvol_feat_channels=8)
    cfg = dataclasses.replace(TINY, costvol_feat_channels=8)
    target, sources, seg = _images(76, 2, H, W, 3), _images(77, 2, 1, H, W, 3), _seg(78, 2, H, W)
    jmodel, params, _ = _davo_pair(jcfg, cfg, target, sources, seg)
    flags = {"fuse_estimator": True}
    want = JDavoModel(_fused(jcfg, **flags)).apply(
        params, jnp.asarray(target), jnp.asarray(sources), seg=jnp.asarray(seg), train=False
    )
    model = DavoModel(_fused(cfg, **flags), device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(_t(target), _t(sources), seg=_t(seg))
    _close(got["poses"], want["poses"], 1e-4)
    _close(got["attn"], want["attn"], 1e-4)


def test_fuse_compute_modes_are_checked():
    for mode in ("", "float32", "bfloat16", "bf16_dot"):
        DavoModel(dataclasses.replace(TINY, fuse_compute=mode, **SERVING_FLAGS), device="cpu")
    with pytest.raises(ValueError, match="fuse_compute"):
        DavoModel(dataclasses.replace(TINY, fuse_compute="float16"), device="cpu")


# ------------------------------------------------------ fused training path
#
# Each `_train` flag on tiny (f32): the port's outputs and parameter
# gradients (its `rowconv_ad` functions on CPU tensors: the plain
# backwards) against the reference module with the same flag under
# `jax.grad` (its Pallas VJPs in interpret mode), on one converted tree:
# outputs within 1e-5, every gradient leaf within 1e-4 of its largest
# element. As tests/test_models.py's fused-train checks, with the
# reference's fused module in place of its XLA path.


def _grads_match_reference(jcls, cls, jcfg, cfg, port_args, key, loss, inputs, out_tol=1e-5):
    jinputs = [jnp.asarray(a) for a in inputs]
    params = jcls(jcfg).init(jax.random.key(key), *jinputs)
    jmodel = jcls(jcfg)
    want_out = jmodel.apply(params, *jinputs)
    jgrads = jax.grad(lambda p: loss(jmodel.apply(p, *jinputs)))(params)
    model = cls(cfg, *port_args)
    load_flax_params(model, params)
    got_out = model(*map(_t, inputs))
    loss(got_out).backward()
    _close_all(got_out, want_out, out_tol)
    want_grads, _ = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert got_grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        assert got_grads[name] is not None, name
        scale = float(want.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got_grads[name].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale, err_msg=name)


def _sum_squares(out):
    """The sum of squares of a module's output(s), JAX arrays or tensors."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum(((o.float() if isinstance(o, torch.Tensor) else o.astype(jnp.float32)) ** 2).sum() for o in outs)


def test_fused_train_posenet_grads_match_reference():
    t, s = _images(90, 2, H, W, 3), _images(91, 2, H, W, 3)
    extra = np.random.default_rng(92).normal(size=(2, H, W, 3)).astype(np.float32)
    flags = {"fuse_pose_encoder_train": True}
    _grads_match_reference(JPoseNet, PoseNet, dataclasses.replace(J_TINY, **flags),
                           dataclasses.replace(TINY, **flags), (3,), 20, _sum_squares, (t, s, extra))


def test_fused_train_dispnet_grads_match_reference():
    """fuse_disp_encoder_train: the (s2, s1)-pair prefix with its taps as
    the skips, whose cotangents arrive through both the decoder and the
    chain. (fuse_disp_encoder's forward is held by
    test_fused_dispnet_matches_reference.)"""
    img = _images(93, 2, H, W, 3)
    flags = {"fuse_disp_encoder_train": True}
    _grads_match_reference(JDispNet, DispNet, dataclasses.replace(J_TINY, **flags),
                           dataclasses.replace(TINY, **flags), (), 21, _sum_squares, (img,))


@pytest.mark.parametrize("flag", ["fuse_disp_encoder", "fuse_disp_encoder_train"])
def test_fused_dispnet_matches_reference(flag):
    img = _images(94, 2, H, W, 3)
    jinputs = [jnp.asarray(img)]
    params = JDispNet(J_TINY).init(jax.random.key(22), *jinputs)
    want = JDispNet(dataclasses.replace(J_TINY, **{flag: True})).apply(params, *jinputs)
    fused, plain = DispNet(dataclasses.replace(TINY, **{flag: True})), DispNet(TINY)
    load_flax_params(fused, params)
    load_flax_params(plain, params)
    with torch.no_grad():
        got, unfused = fused(_t(img)), plain(_t(img))
    _close_all(got, want, 1e-5)
    _close_all(got, unfused, 1e-5)


@pytest.mark.parametrize("flags", [
    {"fuse_estimator_train": True},
    {"fuse_flow_level_train": True},
    {"fuse_flow_level_train": True, "costvol_feat_channels": 8},
    {"fuse_pyramid_train": True},
], ids=["estimator", "flow_level", "flow_level_proj8", "pyramid"])
def test_fused_train_flownet_grads_match_reference(flags):
    """Flows and parameter gradients; with costvol_feat_channels=8 the
    gradients reach cv_proj through d f1 and d f2 of the level."""
    a, b = _images(95, 2, H, W, 3), _images(96, 2, H, W, 3)
    _grads_match_reference(JFlowNetLite, FlowNetLite, dataclasses.replace(J_TINY, **flags),
                           dataclasses.replace(TINY, **flags), (), 23, _sum_squares, (a, b), out_tol=1e-4)


def test_fused_train_region_attention_grads_match_reference():
    flow = np.random.default_rng(97).normal(scale=2.0, size=(3, H, W, 2)).astype(np.float32)
    flags = {"fuse_attention_train": True}
    _grads_match_reference(JRegionAttention, RegionAttention, dataclasses.replace(J_TINY, **flags),
                           dataclasses.replace(TINY, **flags), (2,), 24, _sum_squares, (flow,))
