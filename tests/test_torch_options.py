"""Options of davo_tpu_torch that the earlier slices refused, against the
JAX package (CPU): the space-to-depth first conv (`s2d_first_conv`), the
resnet DispNet encoder (`davo-res`), scan-chunked serving
(`predict_sequence(scan_chunks=...)`, `infer --scan-chunks`),
and the resumable evaluation (`eval/resumable.py`). `infer
--serving-flags` is tests/test_torch_serving_flags.py's.

Tolerances: float32 layers and DispNet within 1e-5, whole-model poses
within 1e-4 (as tests/test_torch_models.py holds them), a train step's
loss terms within 1e-4 of the reference's total; bf16 by the rule of
test_conv_block_bf16_rounds_as_reference (at most 1e-3 of the elements
apart, by at most one ulp); the scan path and a resumed run equal to the
per-call path and to an uninterrupted run within 1e-6.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.config import TrainConfig as JTrainConfig
from davo_tpu.eval import resumable as jresumable
from davo_tpu.eval.runner import iter_pair_batches as j_iter_pair_batches
from davo_tpu.models import presets as jpresets
from davo_tpu.models.common import ConvBlock as JConvBlock
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.models.dispnet import DispNet as JDispNet
from davo_tpu.models.dispnet import ResBlock as JResBlock
from davo_tpu.train.losses import total_loss as j_total_loss
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.config import Config, ModelConfig, TrainConfig
from davo_tpu_torch.convert import flax_to_state_dict, load_flax_params
from davo_tpu_torch.data.snippets import MultiSourceDataset
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.eval import resumable
from davo_tpu_torch.eval.resumable import EvalCursor, params_fingerprint, resumable_predict_sequence
from davo_tpu_torch.eval.runner import iter_pair_batches, make_pose_apply_fn, make_pose_apply_scan_fn, predict_sequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.common import ConvBlock, lecun_init_
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.dispnet import DispNet, ResBlock
from davo_tpu_torch.train import loop

TINY = presets.get("tiny").model
J_TINY = jpresets.get("tiny").model
H, W = TINY.img_height, TINY.img_width


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _uniform(seed, *shape, lo=0.0):
    return np.random.default_rng(seed).uniform(lo, 1.0, size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


# ------------------------------------------------------------- s2d_first_conv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_s2d_conv_block_matches_reference_and_plain(kernel, dtype):
    """`ConvBlock(s2d=True)` at stride 2: the same Conv_0 parameters, the
    space-to-depth evaluation. float32 within 1e-5 of the reference's
    s2d block and of the port's plain conv; bf16 by the rounding rule
    (the conv's output rounded, then the bias added in bf16). An odd-size
    input takes the plain conv, as in the reference."""
    x = _uniform(kernel, 2, 16, 20, 9, lo=-1.0)
    jdt, dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jblock = JConvBlock(12, kernel, 2, jdt, s2d=True)
    params = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.key(kernel), jnp.asarray(x)))
    params["params"]["Conv_0"]["bias"] = np.random.default_rng(1).normal(scale=0.5, size=12).astype(np.float32)
    want = np.asarray(jax.jit(jblock.apply)(params, x).astype(jnp.float32))
    s2d, plain = ConvBlock(9, 12, kernel, 2, dt, s2d=True), ConvBlock(9, 12, kernel, 2, dt)
    load_flax_params(s2d, params)
    load_flax_params(plain, params)
    with torch.no_grad():
        got = s2d(_t(x)).float().numpy()
        got_plain = plain(_t(x)).float().numpy()
        odd = _t(x[:, :15, :19])
        assert torch.equal(s2d(odd), plain(odd))
    assert got.shape == want.shape == (2, 8, 10, 12)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, got_plain, rtol=0, atol=1e-5)
    else:
        assert np.mean(got != want) <= 1e-3
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def _davo_init(jcfg, target, sources, seg):
    """(serving outputs, parameters) of the reference, in one compile."""
    jmodel = JDavoModel(jcfg)
    return jax.jit(lambda t, s, g: jmodel.init_with_output(jax.random.key(0), t, s, seg=g, train=False))(
        target, sources, seg)


def test_s2d_whole_model_matches_reference_and_plain():
    """`tiny` with s2d_first_conv (the pose encoder's 7x7 and the flow
    pyramid's first 3x3): poses within 1e-4 of the reference's and within
    1e-5 of the same model without it. With fuse_pose_encoder and
    fuse_pyramid the fused chains take both first layers, as in the
    reference: the s2d flag then changes nothing."""
    cfg, jcfg = (dataclasses.replace(c, s2d_first_conv=True) for c in (TINY, J_TINY))
    target, sources = _uniform(20, 2, H, W, 3), _uniform(21, 2, 1, H, W, 3)
    seg = np.random.default_rng(22).integers(0, 19, (2, H, W)).astype(np.int32)
    want, params = _davo_init(jcfg, target, sources, seg)
    models = {}
    for name, c in (("s2d", cfg), ("plain", TINY),
                    ("fused s2d", dataclasses.replace(cfg, fuse_pose_encoder=True, fuse_pyramid=True)),
                    ("fused", dataclasses.replace(TINY, fuse_pose_encoder=True, fuse_pyramid=True))):
        models[name] = DavoModel(c, device="cpu")
        load_flax_params(models[name], params)
    assert models["s2d"].posenet.encoder.enc0.Conv_0.s2d and models["s2d"].flownet.pyramid.feat0a.Conv_0.s2d
    with torch.no_grad():
        got = {k: m(_t(target), _t(sources), seg=_t(seg))["poses"].numpy() for k, m in models.items()}
    np.testing.assert_allclose(got["s2d"], np.asarray(want["poses"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["s2d"], got["plain"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["fused s2d"], got["fused"])


# ------------------------------------------------------------------ davo-res


def _res_widths(**kw):
    """`davo-res`'s widths (7 DispNet levels, 32..512 channels; pose 16..256)
    at `tiny`'s 48x64, float32."""
    over = dict(img_height=H, img_width=W, compute_dtype="float32", **kw)
    return presets.with_overrides("davo-res", **over).model, jpresets.with_overrides("davo-res", **over).model


def test_davo_res_dispnet_matches_reference():
    cfg, jcfg = _res_widths()
    img = _uniform(30, 2, H, W, 3)
    jnet = JDispNet(jcfg)
    want, params = jax.jit(lambda x: jnet.init_with_output(jax.random.key(3), x))(img)
    state, _ = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    # The stem is a ConvBlock; every other level a strided ResBlock with a
    # projection, then one without.
    assert {"enc0.Conv_0.weight", "enc0b.conv1.weight", "enc0b.conv2.weight", "enc1.proj.weight",
            "enc6b.conv2.bias"} <= set(state)
    assert not any(k.startswith(("enc0b.proj", "enc1b.proj")) for k in state)
    net = DispNet(cfg)
    assert isinstance(net.enc3, ResBlock) and hasattr(net.enc3, "proj")
    load_flax_params(net, params)
    with torch.no_grad():
        got = net(_t(img))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_davo_res_bf16_residual_rounds_as_reference():
    """The residual sum in bf16, as the reference adds it: a ResBlock's
    output by the bf16 rounding rule."""
    x = _uniform(31, 2, 12, 16, 24, lo=-1.0)
    jblock = JResBlock(32, 2, jnp.bfloat16)
    params = jblock.init(jax.random.key(4), jnp.asarray(x))
    want = np.asarray(jax.jit(jblock.apply)(params, x).astype(jnp.float32))
    block = ResBlock(24, 32, 2, torch.bfloat16)
    load_flax_params(block, params)
    with torch.no_grad():
        got = block(_t(x)).float().numpy()
    assert np.mean(got != want) <= 1e-3
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def _batch(seed=3):
    ds = MultiSourceDataset([SyntheticSequence(n_frames=6, height=H, width=W, seed=i) for i in range(2)],
                            batch_size=2, with_seg=True, augment=True, seed=seed)
    return next(ds.batches(steps=1))


def test_davo_res_train_step_matches_reference():
    """One train step with the resnet encoder (at `tiny`'s widths: the
    DispNet test above holds davo-res's): the training forward's
    disparity maps within 1e-5, poses within 1e-4, the loss terms within
    1e-4 of the reference's total; the update moves the ResBlocks'
    parameters."""
    cfg, jcfg = (dataclasses.replace(c, disp_encoder="resnet") for c in (TINY, J_TINY))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JDavoModel(jcfg)
    jtrain = JTrainConfig(batch_size=2)

    @jax.jit
    def reference(b):
        out, params = jmodel.init_with_output(jax.random.key(0), b["target"], b["sources"], seg=b["seg"],
                                              train=True, source_disp=True)
        _, metrics = j_total_loss(out, b, jcfg, jtrain, step=jnp.asarray(125, jnp.int32))
        return params, out, metrics

    params, want_out, want = reference(jb)
    state = loop.create_state(Config(model=cfg, train=TrainConfig(batch_size=2)), "cpu")
    load_flax_params(state.model, params)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = state.model(tb["target"], tb["sources"], seg=tb["seg"], train=True, source_disp=True)
    np.testing.assert_allclose(out["poses"].numpy(), np.asarray(want_out["poses"]), rtol=0, atol=1e-4)
    for g, w in zip(out["disp"] + out["disp_src"], want_out["disp"] + want_out["disp_src"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    state.step = 125
    before = state.model.dispnet.enc2.conv1.weight.detach().clone()
    _, metrics = loop.make_train_step(Config(model=cfg, train=TrainConfig(batch_size=2)), "cpu")(state, batch)
    total = abs(float(want["total"]))
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), float(want[key]), rtol=0, atol=1e-4 * total, err_msg=key)
    assert not torch.equal(state.model.dispnet.enc2.conv1.weight, before)


@pytest.mark.parametrize("flag", ["fuse_disp_encoder", "fuse_disp_encoder_train"])
def test_fuse_disp_encoder_is_ignored_with_resnet(flag):
    """The fused DispNet encoder is conv-only, as in the reference: with
    the resnet encoder both flags are ignored, not refused."""
    cfg = dataclasses.replace(TINY, disp_encoder="resnet")
    img = _t(_uniform(32, 2, H, W, 3))
    plain = lecun_init_(DispNet(cfg), torch.Generator().manual_seed(0))
    fused = DispNet(dataclasses.replace(cfg, **{flag: True}))
    fused.load_state_dict(plain.state_dict())
    assert not fused.fuse
    with torch.no_grad():
        for g, w in zip(fused(img), plain(img)):
            assert torch.equal(g, w)


# --------------------------------------------------------------- scan serving


@pytest.fixture(scope="module")
def world():
    return SyntheticSequence(n_frames=10, height=H, width=W, seed=5)


def _frames(world):
    frames = np.stack([world.frame(i) for i in range(len(world))])
    seg = np.stack([world.seg(i) for i in range(len(world))]).astype(np.int32)
    return frames, seg


@pytest.mark.parametrize("attention", ["none", "flow_seg"])
def test_scan_equals_per_call(world, attention):
    """tests/test_train.py's case: 9 pairs in batches of 4 are 3 batches;
    2 a call leave a last group of 1 pair, padded by repeating it and
    trimmed on return."""
    model = DavoModel(dataclasses.replace(TINY, attention=attention), device="cpu", seed=2)
    frames, seg = _frames(world)
    seg = seg if attention == "flow_seg" else None
    rels = predict_sequence(make_pose_apply_fn(model), frames, seg=seg, batch_size=4)
    scan = make_pose_apply_scan_fn(model)
    rels_scan = predict_sequence(scan, frames, seg=seg, batch_size=4, scan_chunks=2)
    assert rels_scan.shape == rels.shape == (9, 4, 4)
    np.testing.assert_allclose(rels_scan, rels, rtol=0, atol=1e-6)
    batches = [b for b in iter_pair_batches(frames, seg, 4)]
    out = scan(np.stack([b[2] for b in batches[:2]]), np.stack([b[3] for b in batches[:2]]),
               None if seg is None else np.stack([b[4] for b in batches[:2]]))
    assert tuple(out.shape) == (2, 4, 6) and out.dtype == torch.float32


def test_iter_pair_batches_start0_matches_reference(world):
    frames, seg = _frames(world)
    for start0 in (0, 4, 7, 9):
        got = list(iter_pair_batches(frames, seg, 4, start0))
        want = list(j_iter_pair_batches(frames, seg, 4, start0))
        assert [(s, e) for s, e, *_ in got] == [(s, e) for s, e, *_ in want]
        for g, w in zip(got, want):
            for a, b in zip(g[2:], w[2:]):
                np.testing.assert_array_equal(a, b)
    assert [(s, e) for s, e, *_ in iter_pair_batches(frames, None, 4, 4)] == [(4, 8), (8, 9)]


def test_cli_infer_scan_chunks_equals_per_call(tmp_path):
    paths = {}
    for chunks in (1, 4):
        paths[chunks] = str(tmp_path / f"p{chunks}.txt")
        rc, _ = _run(["infer", "--version", "tiny", "--seq", "1", "--out", paths[chunks], "--batch-size", "4",
                      "--scan-chunks", str(chunks), "--device", "cpu"])
        assert rc == 0
    one, four = np.loadtxt(paths[1]), np.loadtxt(paths[4])
    assert one.shape == (32, 12)
    np.testing.assert_allclose(four, one, rtol=0, atol=1e-6 * np.abs(one).max())


# ---------------------------------------------------------- resumable evaluation

# tests/test_resumable.py's model: 32x32, two narrow levels, no attention.
RESUMABLE = ModelConfig(img_height=32, img_width=32, pose_channels=(8, 12), disp_channels=(8, 12),
                        flow_levels=2, flow_search_range=2, attention="none", pose_scale=1.0,
                        compute_dtype="float32")


@pytest.fixture(scope="module")
def model_and_frames():
    world = SyntheticSequence(n_frames=14, height=32, width=32, seed=6)
    frames = np.stack([world.frame(i) for i in range(len(world))])
    model = DavoModel(RESUMABLE, device="cpu", seed=0)
    return model, make_pose_apply_fn(model), frames


def test_crash_and_resume_identical(model_and_frames, tmp_path):
    _, apply_fn, frames = model_and_frames
    rels_ref = predict_sequence(apply_fn, frames, batch_size=4)
    path = str(tmp_path / "cursor.json")
    cursor = EvalCursor(path)
    with pytest.raises(RuntimeError, match="injected fault"):
        resumable_predict_sequence(apply_fn, frames, cursor, "seq0", batch_size=4, crash_after_batches=2)
    assert cursor.next_pair("seq0") == 8  # 2 batches committed
    assert not (tmp_path / "cursor.json.tmp").exists()  # committed by rename
    cursor2 = EvalCursor(path)  # the relaunch reads the cursor from disk
    rels = resumable_predict_sequence(apply_fn, frames, cursor2, "seq0", batch_size=4)
    assert cursor2.done("seq0", len(frames) - 1)
    uninterrupted = resumable_predict_sequence(apply_fn, frames, EvalCursor(str(tmp_path / "u.json")), "u",
                                               batch_size=4)
    np.testing.assert_array_equal(rels, uninterrupted)
    assert rels.shape == rels_ref.shape == (13, 4, 4)
    np.testing.assert_allclose(rels, rels_ref, rtol=0, atol=1e-6)


def test_fresh_run_no_cursor_file(model_and_frames, tmp_path):
    _, apply_fn, frames = model_and_frames
    rels = resumable_predict_sequence(apply_fn, frames, EvalCursor(str(tmp_path / "c2.json")), "s", batch_size=8)
    assert rels.shape == (len(frames) - 1, 4, 4)


def test_stale_cursor_reset(model_and_frames, tmp_path):
    """A cursor of another model or another sequence length is discarded,
    not resumed."""
    model, apply_fn, frames = model_and_frames
    path = str(tmp_path / "c3.json")
    cursor = EvalCursor(path)
    resumable_predict_sequence(apply_fn, frames, cursor, "s", batch_size=4, fingerprint="modelA")
    assert cursor.next_pair("s") == len(frames) - 1
    cursor2 = EvalCursor(path)
    rels = resumable_predict_sequence(apply_fn, frames, cursor2, "s", batch_size=4, fingerprint="modelB")
    assert rels.shape == (len(frames) - 1, 4, 4) and len(cursor2.rels("s")) == len(frames) - 1
    rels_short = resumable_predict_sequence(apply_fn, frames[:9], EvalCursor(path), "s", batch_size=4,
                                            fingerprint="modelB")
    assert rels_short.shape == (8, 4, 4)

    stamp = params_fingerprint(model)
    assert stamp == params_fingerprint(model.state_dict()) and stamp.startswith("p")
    p = {"a": np.ones((3, 3), np.float32)}
    q = {"a": np.full((3, 3), 2.0, np.float32)}
    assert params_fingerprint(p) == params_fingerprint(p) != params_fingerprint(q)
    # A leaf that has no layout question stamps as in the reference.
    assert params_fingerprint({"a": torch.ones(3, 3)}) == jresumable.params_fingerprint(p)


def _numpy_apply(t, s, g=None):
    """A stand-in pose function of the images, in numpy for both packages."""
    t, s = np.asarray(t), np.asarray(s)
    return np.concatenate([t.mean((1, 2)), s.mean((1, 2))], -1).astype(np.float32) * 0.1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cursor_json_is_read_across_packages(model_and_frames, tmp_path, writer):
    """The cursor layout is the reference's: a run that crashes under one
    package resumes under the other and gives the uninterrupted run's
    pose vectors; a cursor without a model stamp carries only the
    sequence length."""
    _, _, frames = model_and_frames
    path = str(tmp_path / "cursor.json")
    first, second = (jresumable, resumable) if writer == "reference" else (resumable, jresumable)
    with pytest.raises(RuntimeError, match="injected fault"):
        first.resumable_predict_sequence(_numpy_apply, frames, first.EvalCursor(path), "s", batch_size=4,
                                         crash_after_batches=2)
    with open(path) as f:
        saved = json.load(f)
    assert saved["s"]["next_pair"] == 8 and saved["s"]["fingerprint"] == "n13" and len(saved["s"]["rel_vecs"]) == 8
    cursor = second.EvalCursor(path)
    assert cursor.next_pair("s") == 8
    np.asarray(second.resumable_predict_sequence(_numpy_apply, frames, cursor, "s", batch_size=4))
    want = np.concatenate([_numpy_apply(t, s) for _, _, t, s, _ in iter_pair_batches(frames, None, 4)])[:13]
    np.testing.assert_allclose(np.asarray(second.EvalCursor(path).rels("s"), np.float32), want, rtol=0, atol=0)
    rels = resumable.resumable_predict_sequence(_numpy_apply, frames, resumable.EvalCursor(path), "s", batch_size=4)
    assert rels.shape == (13, 4, 4) and np.isfinite(rels).all()
