"""The port's trajectory backend from the CLI: serving its own checkpoints
(`infer --ckpt`, `--tum`), `depth`, `eval --devkit`, `eval-depth` and
`ba`, on the CPU at the `tiny` preset; and the evaluation modules
against the reference's.

Tolerances: TUM text against the reference's where the reference's
quaternions are accurate, and its round trip, 1e-6 (9 decimals); `depth_errors` and the C++ devkit
equal to the reference's (the same numpy and the same C++ source); the
poses of `infer --ckpt` within 1e-6 of the largest of those of the same
checkpoint restored in memory (the same float32 program).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.cli.main import main as j_cli_main
from davo_tpu.core import geometry as jgeo
from davo_tpu.eval import depth_metrics as jdepth_metrics
from davo_tpu.eval import devkit as jdevkit
from davo_tpu.eval import tum as jtum
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.data.kitti import write_poses_kitti
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.eval import depth_metrics, devkit, tum
from davo_tpu_torch.eval.metrics import kitti_seg_errors
from davo_tpu_torch.eval.runner import assemble_trajectory, make_pose_apply_fn, predict_sequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.train import loop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(argv):
    """(rc, stdout) of one CLI command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def _drive(rng, n=1200):
    """A forward drive of ~1 m a frame with yaw wobble (covers 800 m),
    and a corrupted copy: tests/test_devkit.py's fixture."""
    xi = np.zeros((n - 1, 6))
    xi[:, 2] = 1.0 + rng.normal(0, 0.05, n - 1)
    xi[:, 4] = rng.normal(0, 0.002, n - 1)
    rel = np.asarray(jgeo.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
    noise = np.asarray(jgeo.se3_exp(jnp.asarray(np.concatenate(
        [rng.normal(0, 0.02, (n - 1, 3)), rng.normal(0, 2e-3, (n - 1, 3))], 1), jnp.float32)), np.float64)
    gt, pred = [np.eye(4)], [np.eye(4)]
    for r, e in zip(rel, noise):
        gt.append(gt[-1] @ r)
        pred.append(pred[-1] @ (e @ r))
    return np.stack(gt), np.stack(pred)


def test_tum_text_matches_reference_and_round_trips(rng):
    """The reference's layout; every rotation round-trips within 1e-6,
    where the reference's quaternions (each magnitude from the diagonal)
    lose up to ~1e-4 on small rotations, a VO trajectory's
    frame-to-frame rotations, and near pi. Where the reference is
    accurate, the texts agree within 1e-6."""
    generic = np.concatenate([rng.normal(0, 3.0, (6, 3)), rng.normal(0, 1.0, (6, 3))], -1)
    small = np.concatenate([rng.normal(0, 3.0, (6, 3)), rng.normal(0, 1e-3, (6, 3))], -1)
    near_pi = np.array([[1.0, 2.0, 3.0, 0.0, np.pi - 1e-6, 0.0]])  # qw ~ 0
    for xi, ref_accurate in ((generic, True), (small, False), (near_pi, False)):
        poses = np.asarray(jgeo.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
        times = np.arange(len(poses)) * 0.1
        text = tum.format_poses_tum(poses, times)
        t, back = tum.parse_poses_tum(text)
        np.testing.assert_allclose(t, times, rtol=0, atol=1e-6)
        np.testing.assert_allclose(back, poses, rtol=0, atol=1e-6)
        want = jtum.format_poses_tum(poses, times)
        ref_err = np.abs(jtum.parse_poses_tum(want)[1] - poses).max()
        if ref_accurate:
            np.testing.assert_allclose(np.loadtxt(text.splitlines()), np.loadtxt(want.splitlines()), rtol=0,
                                       atol=1e-6)
        else:
            assert ref_err > 1e-6, ref_err


def test_depth_errors_equal_the_reference(rng):
    gt = rng.uniform(0.5, 90.0, (3, 12, 16))
    gt[0, :2] = 0.0  # outside [min, max]: masked
    pred = gt * rng.uniform(0.7, 1.4, gt.shape) * np.array([1.0, 2.0, 0.5])[:, None, None]
    for kw in ({}, {"median_scale": False}, {"min_depth": 1.0, "max_depth": 50.0}):
        assert depth_metrics.depth_errors(gt, pred, **kw) == jdepth_metrics.depth_errors(gt, pred, **kw)
    empty = depth_metrics.depth_errors(np.zeros((1, 4, 4)), np.ones((1, 4, 4)))
    assert empty["n_valid"] == 0 and np.isnan(empty["abs_rel"])


def test_kitti_seg_errors_cpp_equals_the_reference(rng):
    gt, pred = _drive(rng)
    got = devkit.kitti_seg_errors_cpp(gt, pred)
    assert got == jdevkit.kitti_seg_errors_cpp(gt, pred)
    assert got["n_segments"] > 0
    py = kitti_seg_errors(gt, pred)
    assert got["t_err_pct"] == pytest.approx(py["t_err_pct"], rel=1e-5)
    assert got["r_err_deg_per_100m"] == pytest.approx(py["r_err_deg_per_100m"], rel=1e-5)
    short = devkit.kitti_seg_errors_cpp(gt[:30], pred[:30])  # no 100 m segment
    assert short["n_segments"] == 0 and np.isnan(short["t_err_pct"])
    # Built from the reference's source into the port's build directory,
    # never into tools/kitti_devkit/, where the reference's tests build.
    assert devkit._build().parent == devkit.BUILD_DIR
    with pytest.raises(ValueError, match="trajectories"):
        devkit.kitti_seg_errors_cpp(gt[:5], pred[:4])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A `tiny` checkpoint written by `cli train` (one step)."""
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("ckpt")
    rc, _ = _run(["train", "--version", "tiny", "--steps", "1", "--worlds", "1", "--world-frames", "6",
                  "--checkpoint-dir", str(path), "--device", "cpu"])
    assert rc == 0 and [s for s, _ in loop._checkpoints(str(path))] == [1]
    return str(path)


def test_backend_chain_on_cpu(ckpt, tmp_path):
    """train -> infer --ckpt (--tum) -> depth -> eval --devkit ->
    eval-depth -> ba, as a user runs them."""
    P, T, G, D, R = (str(tmp_path / n) for n in ("p.txt", "p.tum", "g.txt", "depth", "r.txt"))
    rc, _ = _run(["infer", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--out", P, "--tum", T,
                  "--gt-out", G, "--device", "cpu"])
    assert rc == 0
    poses = np.loadtxt(P).reshape(-1, 3, 4)
    assert poses.shape == (32, 3, 4) and np.isfinite(poses).all()

    # The same checkpoint restored in memory, as training restores it.
    cfg = presets.get("tiny")
    state = loop.restore_checkpoint(ckpt, loop.create_state(cfg, "cpu"))
    world = SyntheticSequence(n_frames=32, height=48, width=64, seed=1)
    frames = np.stack([world.frame(i) for i in range(32)])
    seg = np.stack([world.seg(i) for i in range(32)])
    want = assemble_trajectory(predict_sequence(make_pose_apply_fn(state.model), frames, seg=seg), device="cpu")
    np.testing.assert_allclose(poses, want[:, :3], rtol=0, atol=1e-6 * np.abs(want).max())
    _, from_tum = tum.parse_poses_tum(open(T).read())
    np.testing.assert_allclose(from_tum[:, :3], poses, rtol=0, atol=1e-6)

    rc, _ = _run(["depth", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--out", D, "--device", "cpu"])
    assert rc == 0
    files = sorted(os.listdir(D))
    assert files == [f"{i:06d}.npy" for i in range(32)]  # every frame, the last one too
    depth = np.stack([np.load(os.path.join(D, f)) for f in files])
    assert depth.shape == (32, 48, 64) and np.isfinite(depth).all() and (depth > 0).all()

    rc, out = _run(["eval", "--gt", G, "--pred", P, "--devkit"])
    report = json.loads(out)
    assert rc == 0 and report["n_frames"] == 32 and np.isfinite(report["ate_full"])
    for key in ("t_err_pct", "r_err_deg_per_100m"):
        py, cpp = report[key], report[f"{key}_cpp"]
        assert (np.isnan(py) and np.isnan(cpp)) or py == pytest.approx(cpp, rel=1e-5)

    rc, out = _run(["eval-depth", "--depth-dir", D, "--seq", "1"])
    report = json.loads(out)
    assert rc == 0 and report["n_valid"] > 0 and 0.0 <= report["a1"] <= 1.0

    argv = ["ba", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--pred", P, "--depth-dir", D,
            "--out", R, "--device", "cpu"]
    rc, _ = _run(argv)
    refined = np.loadtxt(R).reshape(-1, 3, 4)
    assert rc == 0 and refined.shape == (32, 3, 4) and np.isfinite(refined).all()
    assert np.abs(refined - poses).max() > 0
    np.testing.assert_array_equal(refined[:2], poses[:2])  # the first window's anchors
    assert _run(argv)[0] == 0
    np.testing.assert_array_equal(np.loadtxt(R).reshape(-1, 3, 4), refined)


def test_infer_ckpt_serves_the_fused_path(ckpt, tmp_path):
    """A checkpoint trained without them serves with the four serving
    flags (they route the forward; `create_state` refuses them): the same
    trajectory as unfused (tiny is float32; the fused kernels' plain
    versions on the CPU), at the 1e-4 of
    test_torch_eval.py::test_cli_infer_runs_the_fused_serving_path."""
    flags = ["--set", "model.fuse_pyramid=true", "--set", "model.fuse_flow_level=true",
             "--set", "model.fuse_attention=true", "--set", "model.fuse_pose_encoder=true"]
    paths = {}
    for name, sets in (("fused", flags), ("unfused", [])):
        paths[name] = str(tmp_path / f"{name}.txt")
        rc, _ = _run(["infer", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--out", paths[name],
                      "--device", "cpu", *sets])
        assert rc == 0
    np.testing.assert_allclose(np.loadtxt(paths["fused"]), np.loadtxt(paths["unfused"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("cmd", ["infer", "depth", "ba"])
def test_no_checkpoint_found_returns_1(cmd, tmp_path, capsys):
    pred = tmp_path / "p.txt"
    write_poses_kitti(str(pred), np.tile(np.eye(4), (32, 1, 1)))
    extra = ["--pred", str(pred)] if cmd == "ba" else []
    empty = tmp_path / "empty"
    empty.mkdir()
    rc = cli_main([cmd, "--version", "tiny", "--ckpt", str(empty), "--seq", "1",
                   "--out", str(tmp_path / "out"), "--device", "cpu", *extra])
    assert rc == 1
    assert f"no checkpoint found in {empty}" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("sets", [["model.attention=flow"], ["model.flow_levels=4"]])
def test_a_checkpoint_that_does_not_match_the_config_raises(ckpt, tmp_path, sets):
    argv = ["infer", "--version", "tiny", "--ckpt", ckpt, "--seq", "1", "--out", str(tmp_path / "p.txt"),
            "--device", "cpu"]
    with pytest.raises(RuntimeError, match="state_dict"):
        cli_main([*argv, *(a for s in sets for a in ("--set", s))])
    assert not (tmp_path / "p.txt").exists()


def test_backend_commands_default_to_the_gpu(ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    pred = tmp_path / "p.txt"
    write_poses_kitti(str(pred), np.tile(np.eye(4), (32, 1, 1)))
    for argv in (["depth", "--out", str(tmp_path / "d")],
                 ["depth", "--ckpt", ckpt, "--out", str(tmp_path / "d")],
                 ["ba", "--pred", str(pred), "--out", str(tmp_path / "r.txt")],
                 ["ba", "--ckpt", ckpt, "--pred", str(pred), "--out", str(tmp_path / "r.txt")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_main([*argv, "--version", "tiny", "--seq", "1"])
    assert not (tmp_path / "r.txt").exists()


def test_reference_ba_cannot_read_the_reference_depth_output(tmp_path):
    """The reference's `depth` writes frames 0..N-2 (`n = len(frames) - 1`),
    its `ba --depth-dir` reads N maps: the documented chain stops at the
    last frame's map. The port's `depth` writes all N (see
    test_backend_chain_on_cpu)."""
    depth_dir = tmp_path / "depth"
    depth_dir.mkdir()
    for i in range(31):  # what the reference's depth writes for the CLI's 32-frame world
        np.save(depth_dir / f"{i:06d}.npy", np.ones((48, 64), np.float32))
    pred = tmp_path / "p.txt"
    write_poses_kitti(str(pred), np.tile(np.eye(4), (32, 1, 1)))
    with pytest.raises(FileNotFoundError, match="000031.npy"):
        j_cli_main(["ba", "--version", "tiny", "--seq", "1", "--pred", str(pred), "--depth-dir", str(depth_dir),
                    "--out", str(tmp_path / "r.txt")])
