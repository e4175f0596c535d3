"""davo_tpu_torch streaming inference end to end against the JAX
reference (CPU), the CLI, and the no-silent-CPU-fallback rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.eval import runner as jrunner
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu_torch import resolve_device
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.data.kitti import write_poses_kitti
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.eval import runner
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_stream_matches_reference_end_to_end():
    """predict_sequence -> assemble_trajectory -> evaluate_sequence on a
    17-frame tiny synthetic world (16 pairs in batches of 6: the last
    batch is padded), both packages with the same parameters."""
    jcfg, cfg = jpresets.get("tiny").model, presets.get("tiny").model
    world = SyntheticSequence(n_frames=17, height=48, width=64, seed=0)
    frames = np.stack([world.frame(i) for i in range(len(world))]).astype(np.float32)
    seg = np.stack([world.seg(i) for i in range(len(world))])
    jmodel = JDavoModel(jcfg)
    params = jmodel.init(
        jax.random.key(0), jnp.asarray(frames[1:3]), jnp.asarray(frames[:2, None]),
        seg=jnp.asarray(seg[1:3]), train=False,
    )
    model = DavoModel(cfg, device="cpu")
    load_flax_params(model, params)

    jfn = jrunner.make_pose_apply_fn(jmodel, params, jcfg.attention)
    want_traj = jrunner.assemble_trajectory(
        jrunner.predict_sequence(jfn, frames, seg=seg, batch_size=6)
    )
    got_traj = runner.assemble_trajectory(
        runner.predict_sequence(runner.make_pose_apply_fn(model), frames, seg=seg, batch_size=6),
        device="cpu",
    )
    assert got_traj.shape == (17, 4, 4)
    np.testing.assert_allclose(got_traj, want_traj, rtol=0, atol=1e-4)
    got = runner.evaluate_sequence(got_traj, world.poses)
    want = jrunner.evaluate_sequence(want_traj, world.poses)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)



def test_predict_sequence_increments_match_reference():
    """The same pose vectors per batch give the same increments: the port
    forms them from device tensors, the reference from its arrays."""
    frames = np.random.default_rng(5).uniform(size=(11, 8, 10, 3)).astype(np.float32)

    def vecs(tgt, src):
        tgt, src = np.asarray(tgt), np.asarray(src)
        return np.concatenate([(tgt - src).mean((1, 2)), 0.3 * tgt.mean((1, 2))], -1)

    want = jrunner.predict_sequence(lambda t, s, g: jnp.asarray(vecs(t, s)), frames, batch_size=4)
    got = runner.predict_sequence(lambda t, s, g: torch.from_numpy(vecs(t, s)), frames, batch_size=4)
    assert got.shape == (10, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_iter_pair_batches_padding_contract():
    frames = np.arange(11, dtype=np.float32)[:, None, None, None] * np.ones((11, 2, 2, 3), np.float32)
    seg = np.arange(11)[:, None, None] * np.ones((11, 2, 2), np.int32)
    got = list(runner.iter_pair_batches(frames, seg, 4))
    want = list(jrunner.iter_pair_batches(frames, seg, 4))
    assert [(g[0], g[1]) for g in got] == [(0, 4), (4, 8), (8, 10)]
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(a, b)


def test_cli_infer_writes_trajectory(tmp_path):
    out, gt = tmp_path / "poses.txt", tmp_path / "gt.txt"
    rc = cli_main([
        "infer", "--version", "tiny", "--data", "synthetic", "--seq", "0",
        "--out", str(out), "--gt-out", str(gt), "--batch-size", "8",
        "--set", "model.attention_cue=flow_fb", "--device", "cpu",
    ])
    assert rc == 0
    rows = np.loadtxt(out)
    assert rows.shape == (32, 12) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[0], np.eye(4)[:3].reshape(12), atol=0)
    assert np.loadtxt(gt).shape == (32, 12)


@pytest.mark.parametrize(
    "flags, rc, message",
    [
        (["--ckpt", "/nowhere", "--data", "/kitti"], 1, "no checkpoint found in /nowhere"),
        (["--data", "/kitti"], None, None),
        (["--serving-flags"], 2, "not ported"),
    ],
)
def test_cli_refuses_unported_inputs(tmp_path, flags, rc, message, capsys):
    """What `infer` cannot serve writes nothing: a missing checkpoint
    (rc 1), a KITTI root that is not there (the reader's error) and the
    TPU-validated serving flags (rc 2, not ported)."""
    argv = ["infer", "--version", "tiny", "--out", str(tmp_path / "p.txt"), "--device", "cpu", *flags]
    if rc is None:
        with pytest.raises(FileNotFoundError):
            cli_main(argv)
    else:
        assert cli_main(argv) == rc
        assert message in capsys.readouterr().err
    assert not (tmp_path / "p.txt").exists()


def test_entry_points_default_to_the_gpu_and_never_fall_back(tmp_path):
    """With no card, an entry point called without device="cpu" raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = presets.get("tiny").model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DavoModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.assemble_trajectory(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["infer", "--version", "tiny", "--out", str(tmp_path / "p.txt")])
    assert not (tmp_path / "p.txt").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_write_poses_kitti_round_trip(tmp_path):
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = np.arange(9).reshape(3, 3)
    write_poses_kitti(str(tmp_path / "p.txt"), poses)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p.txt"), poses[:, :3].reshape(3, 12))


FUSED_SETS = [
    "--set", "model.fuse_pyramid=true", "--set", "model.fuse_flow_level=true",
    "--set", "model.fuse_attention=true", "--set", "model.fuse_pose_encoder=true",
]


def test_cli_infer_runs_the_fused_serving_path(tmp_path):
    """`infer` with the four serving flags on the CPU (the plain versions
    of the fused kernels): the same trajectory as the unfused path from
    the same seeded parameters (tiny is float32)."""
    paths = {}
    for name, sets in (("fused", FUSED_SETS), ("unfused", [])):
        paths[name] = tmp_path / f"{name}.txt"
        rc = cli_main(["infer", "--version", "tiny", "--data", "synthetic", "--seq", "0",
                       "--out", str(paths[name]), "--batch-size", "8", "--device", "cpu", *sets])
        assert rc == 0
    fused, unfused = np.loadtxt(paths["fused"]), np.loadtxt(paths["unfused"])
    assert fused.shape == (32, 12) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, unfused, rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "sets",
    [
        ["model.fuse_pose_encoder=true"],
        ["model.fuse_flow_level=true"],
        ["model.fuse_attention=true"],
        ["model.fuse_estimator=true", "model.attention=flow"],
    ],
)
def test_train_refuses_serving_only_flags_as_reference(sets, capsys):
    """`cli train` and `create_state` refuse the serving-only flags where
    the reference's `cli train` does, with its message."""
    from davo_tpu.cli.main import main as j_cli_main
    from davo_tpu_torch.train import loop

    argv = ["train", "--version", "tiny", "--steps", "1"]
    for item in sets:
        argv += ["--set", item]
    assert j_cli_main(argv) == 1
    want = capsys.readouterr().err
    assert cli_main([*argv, "--device", "cpu"]) == 1
    assert capsys.readouterr().err == want
    overrides = dict(item.split("=") for item in sets)
    cfg = presets.get("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **{
        k.split(".")[1]: (v == "true" if v in ("true", "false") else v) for k, v in overrides.items()
    }))
    with pytest.raises(ValueError, match="serving-only"):
        loop.create_state(cfg, "cpu")


def test_train_accepts_a_serving_flag_the_forward_never_reaches():
    """fuse_attention with attention="flow": no RegionAttention is built,
    so the reference trains with it, and so does the port."""
    from davo_tpu_torch.train import loop

    cfg = presets.get("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention="flow", fuse_attention=True))
    assert not loop.serving_only_flags_set(cfg.model)
    assert loop.create_state(cfg, "cpu").step == 0
