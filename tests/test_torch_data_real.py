"""The port's real-data path against the JAX package and OpenCV (CPU):
the image codec and resizes (`data/imageio.py`, `csrc/image_codec.h`),
`prep` trees, the Python and native readers, metrics and image
summaries, and the CLI chain prep -> train-seg -> prep --write-seg ->
train -> infer on a KITTI root.

Tolerances: the codec follows libjpeg-turbo's integer DCTs, fancy
upsampling and colour tables, so JPEG pixels, PNG pixels and both
resizes are held EQUAL to OpenCV's (0 levels); the two packages' prepared
trees are equal file for file (text, splits, JPEG pixels, label pixels);
a tree read by either package's reader gives the same arrays.
"""

import filecmp
import json
import os
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.cli import main as j_cli
from davo_tpu.data import prep as jprep
from davo_tpu.models import presets as jpresets
from davo_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from davo_tpu_torch.cli import main as cli
from davo_tpu_torch.config import Config, TrainConfig
from davo_tpu_torch.data import imageio, prep
from davo_tpu_torch.data.native_loader import NativeSnippetLoader
from davo_tpu_torch.data.snippets import MultiSourceDataset
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.train import loop
from davo_tpu_torch.utils.metrics import MetricsLogger

NATIVE_HW = (37, 125)  # a KITTI frame (376 x 1241) at a tenth
SIZE = ("--set", "model.img_height=32", "--set", "model.img_width=104")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _picture(h, w, seed=0, shift=0):
    """A smooth colour picture with noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([
        128 + 100 * np.sin((x + 3 * shift) / 5.0 + y / 7.0),
        128 + 90 * np.cos(x / 4.0 - (y + shift) / 6.0),
        (x * 5 + y * 3 + 7 * shift) % 256,
    ], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def write_kitti_root(root, seqs=("00", "01"), n=8, hw=NATIVE_HW, seg=True):
    """A KITTI odometry root written by OpenCV: image_2 PNGs, calib.txt
    with P2, times.txt, poses/NN.txt and (with `seg`) seg/ label PNGs."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    for s in seqs:
        d = os.path.join(root, "sequences", s)
        os.makedirs(os.path.join(d, "image_2"), exist_ok=True)
        if seg:
            os.makedirs(os.path.join(d, "seg"), exist_ok=True)
        for i in range(n):
            img = _picture(h, w, seed=int(s) * 100 + i, shift=i)
            cv2.imwrite(os.path.join(d, "image_2", f"{i:06d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            if seg:
                lab = ((x // 13 + y // 11 + i) % 19).astype(np.uint8)
                cv2.imwrite(os.path.join(d, "seg", f"{i:06d}.png"), lab)
        P = np.array([[0.7 * w, 0, w / 2, 0], [0, 0.7 * w, h / 2, 0], [0, 0, 1, 0]])
        with open(os.path.join(d, "calib.txt"), "w") as f:
            for k in range(4):
                f.write(f"P{k}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")
        np.savetxt(os.path.join(d, "times.txt"), np.arange(n) * 0.1)
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, 2, 3] = 0.8 * np.arange(n)
        poses[:, 0, 3] = 0.05 * np.sin(np.arange(n))
        np.savetxt(os.path.join(root, "poses", f"{s}.txt"), poses[:, :3, :].reshape(n, 12))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(KITTI root, the port's prepared tree, the reference's), both
    prepared at 32x104 from the same root."""
    base = tmp_path_factory.mktemp("real")
    root = str(base / "kitti")
    write_kitti_root(root)
    port, ref = str(base / "port"), str(base / "ref")
    counts = prep.prepare_kitti_odometry(root, port, 32, 104, seqs=("00", "01"), num_workers=2)
    # The reference forks its pool: one worker here, as JAX holds threads.
    assert jprep.prepare_kitti_odometry(root, ref, 32, 104, seqs=("00", "01"), num_workers=1) == counts
    assert counts == {"train": 11, "val": 1}
    return root, port, ref


# ---------------------------------------------------------------------------
# The codec and the resizes against OpenCV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(32, 312), (31, 97), (128, 1248), (17, 9)])
def test_jpeg_matches_opencv(tmp_path, hw):
    """cv2's files decode to cv2's pixels, and ours encode (quality 95,
    4:2:0) to what cv2's encoder gives, pixel for pixel."""
    img = _picture(*hw, seed=sum(hw))
    theirs, ours = str(tmp_path / "cv.jpg"), str(tmp_path / "ours.jpg")
    cv2.imwrite(theirs, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    imageio.imwrite_jpg(ours, img)
    cv_read = lambda p: cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(imageio.imread_rgb(theirs), cv_read(theirs))
    np.testing.assert_array_equal(cv_read(ours), cv_read(theirs))
    assert imageio.image_info(ours) == (*hw, 3)


def test_png_round_trips_with_opencv(tmp_path):
    rgb, gray = _picture(23, 41), _picture(23, 41)[..., 1].copy()
    imageio.imwrite_png(str(tmp_path / "a.png"), rgb)
    imageio.imwrite_png(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(tmp_path / "a.png")), cv2.COLOR_BGR2RGB), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE), gray)
    cv2.imwrite(str(tmp_path / "b.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(tmp_path / "h.png"), gray)
    cv2.imwrite(str(tmp_path / "rgba.png"), np.dstack([rgb[..., ::-1], gray]))
    np.testing.assert_array_equal(imageio.imread_rgb(str(tmp_path / "b.png")), rgb)
    np.testing.assert_array_equal(imageio.imread_gray(str(tmp_path / "h.png")), gray)
    np.testing.assert_array_equal(imageio.imread_rgb(str(tmp_path / "h.png")), np.repeat(gray[..., None], 3, -1))
    np.testing.assert_array_equal(imageio.imread_rgb(str(tmp_path / "rgba.png")), rgb)


def test_codec_refuses_what_it_does_not_decode(tmp_path):
    img = _picture(16, 24)
    cv2.imwrite(str(tmp_path / "p.jpg"), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cv2.imwrite(str(tmp_path / "d.png"), img.astype(np.uint16) * 257)
    with pytest.raises(OSError, match="progressive"):
        imageio.imread_rgb(str(tmp_path / "p.jpg"))
    with pytest.raises(OSError, match="8-bit"):
        imageio.imread_rgb(str(tmp_path / "d.png"))
    with pytest.raises(OSError, match="open failed"):
        imageio.imread_rgb(str(tmp_path / "missing.png"))
    imageio.imwrite_jpg(str(tmp_path / "c.jpg"), img)
    with pytest.raises(OSError, match="gray"):
        imageio.imread_gray(str(tmp_path / "c.jpg"))


@pytest.mark.parametrize(
    "src, dst", [((376, 1241), (128, 416)), ((37, 125), (16, 52)), ((32, 104), (16, 52)),
                 ((48, 156), (16, 52)), ((375, 1242), (128, 416))],
)
def test_resize_area_matches_opencv(src, dst):
    """INTER_AREA on uint8: KITTI to 128x416 and its tenth (non-integer
    factors), 2x and 3x (OpenCV's integer path), colour and gray."""
    img = _picture(*src, seed=3)
    for x in (img, img[..., 0].copy()):
        want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(imageio.resize_area(x, *dst), want)


@pytest.mark.parametrize("src, dst", [((128, 416), (148, 479)), ((16, 52), (19, 60)), ((376, 1241), (128, 416))])
def test_resize_nearest_matches_opencv(src, dst):
    lab = (_picture(*src)[..., 0] % 19).astype(np.uint8)
    want = cv2.resize(lab, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(imageio.resize_nearest(lab, *dst), want)


# ---------------------------------------------------------------------------
# Prepared trees
# ---------------------------------------------------------------------------


def test_prepared_tree_matches_reference(trees):
    """Names, split lists and text files equal byte for byte; triplets
    and label maps equal pixel for pixel."""
    _, port, ref = trees
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    assert {n.rsplit(".", 1)[1] for n in names} == {"jpg", "png", "txt"}
    for n in names:
        a, b = os.path.join(port, n), os.path.join(ref, n)
        if n.endswith(".txt"):
            assert filecmp.cmp(a, b, shallow=False), n
        elif n.endswith("_seg.png"):
            np.testing.assert_array_equal(imageio.imread_gray(a), cv2.imread(b, cv2.IMREAD_GRAYSCALE))
        else:
            np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b), err_msg=n)


def _write_raw_root(root, n=8, hw=NATIVE_HW):
    """A KITTI raw drive: calib_cam_to_cam.txt (P_rect_02, a calib_time
    line), image_02 PNGs and oxts rows whose speed drops below 1 m/s at
    frame 3 (the three triplets holding it are static and dropped)."""
    date = "2011_09_26"
    drive = os.path.join(root, date, f"{date}_drive_0001_sync")
    os.makedirs(os.path.join(drive, "image_02", "data"))
    os.makedirs(os.path.join(drive, "oxts", "data"))
    h, w = hw
    P = np.array([[0.7 * w, 0, w / 2, 0], [0, 0.7 * w, h / 2, 0], [0, 0, 1, 0]])
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\nP_rect_02: " + " ".join(f"{v:.6e}" for v in P.ravel()) + "\n")
    for i in range(n):
        img = _picture(h, w, seed=500 + i, shift=i)
        cv2.imwrite(os.path.join(drive, "image_02", "data", f"{i:010d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        vals = np.zeros(30)
        vals[6], vals[7] = (0.3, 0.2) if i == 3 else (4.0, 3.0)
        with open(os.path.join(drive, "oxts", "data", f"{i:010d}.txt"), "w") as f:
            f.write(" ".join(str(v) for v in vals))


def _write_cityscapes_root(root, n=6, hw=NATIVE_HW):
    """One leftImg8bit_sequence group with the camera json of one frame."""
    city, seq = "aachen", "000000"
    img_dir = os.path.join(root, "leftImg8bit_sequence", "train", city)
    cam_dir = os.path.join(root, "camera", "train", city)
    os.makedirs(img_dir)
    os.makedirs(cam_dir)
    for i in range(n):
        img = _picture(*hw, seed=700 + i, shift=i)
        cv2.imwrite(os.path.join(img_dir, f"{city}_{seq}_{i:06d}_leftImg8bit.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    with open(os.path.join(cam_dir, f"{city}_{seq}_000003_camera.json"), "w") as f:
        json.dump({"intrinsic": {"fx": 80.5, "fy": 80.5, "u0": 62.0, "v0": 18.5}}, f)


@pytest.mark.parametrize("dataset", ["kitti_raw", "cityscapes"])
def test_raw_and_cityscapes_trees_match_reference(dataset, tmp_path, capsys):
    """`prep --dataset kitti_raw|cityscapes` against the reference's
    function on the same root: the same names (static triplets dropped
    by oxts speed), split and text files, triplet pixels."""
    root = str(tmp_path / "root")
    (_write_raw_root if dataset == "kitti_raw" else _write_cityscapes_root)(root)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert cli.main(["prep", "--dataset", dataset, "--root", root, "--out", port, "--height", "32",
                     "--width", "104", "--num-workers", "1"]) == 0
    fn = jprep.prepare_kitti_raw if dataset == "kitti_raw" else jprep.prepare_cityscapes
    want = fn(root, ref, 32, 104, num_workers=1)
    assert f"prepared {want}" in capsys.readouterr().out
    assert want["train"] + want["val"] == (3 if dataset == "kitti_raw" else 4)
    if dataset == "kitti_raw":
        assert want["static_dropped"] == 3  # the triplets centred on frames 2, 3 and 4
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    for n in names:
        a, b = os.path.join(port, n), os.path.join(ref, n)
        if n.endswith(".txt"):
            assert filecmp.cmp(a, b, shallow=False), n
        else:
            np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b), err_msg=n)


def test_each_package_reads_the_others_tree(trees):
    _, port, ref = trees
    t_on_ref, j_on_port = prep.PreparedSnippets(ref), jprep.PreparedSnippets(port)
    t_on_port, j_on_ref = prep.PreparedSnippets(port), jprep.PreparedSnippets(ref)
    assert t_on_ref.has_seg and t_on_ref.has_gt and j_on_port.has_seg and j_on_port.has_gt
    for name in t_on_port.names:
        mine, theirs = t_on_ref.load(name), j_on_port.load(name)
        want = j_on_ref.load(name)
        assert mine.keys() == theirs.keys() == want.keys() == {"target", "sources", "K", "seg", "gt_pose"}
        for k in want:
            np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
            np.testing.assert_array_equal(theirs[k], t_on_port.load(name)[k], err_msg=k)


def test_python_reader_batches_match_reference(trees):
    _, port, _ = trees
    got = list(prep.PreparedSnippets(port, seed=5).batches(4, steps=5))
    want = list(jprep.PreparedSnippets(port, seed=5).batches(4, steps=5))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# The native loader (tests/test_native_loader.py's cases)
# ---------------------------------------------------------------------------


def test_native_matches_python_reader(trees):
    """Unshuffled epoch == PreparedSnippets item for item, exactly (one
    codec); the ragged tail is dropped."""
    _, port, _ = trees
    native = NativeSnippetLoader(port, batch_size=4, shuffle=False, loop=False, threads=3)
    py = prep.PreparedSnippets(port)
    assert native.names == py.names and (native.height, native.width) == (32, 104)
    got = list(native.batches())
    assert len(got) == len(py.names) // 4
    for bi, batch in enumerate(got):
        for k in range(4):
            item = py.load(py.names[bi * 4 + k])
            for key in ("target", "sources", "K", "seg", "gt_pose"):
                np.testing.assert_array_equal(batch[key][k], item[key], err_msg=key)
    native.close()


def test_native_end_of_data_and_determinism(trees):
    _, port, _ = trees
    runs = []
    for _ in range(2):
        native = NativeSnippetLoader(port, batch_size=4, shuffle=True, loop=False, seed=7)
        runs.append([b["K"].copy() for b in native.batches()])
        native.close()
    assert len(runs[0]) == 2
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_native_looping_stream(trees):
    _, port, _ = trees
    native = NativeSnippetLoader(port, batch_size=4, shuffle=True, loop=True, seed=0, with_seg=False)
    seen = 0
    for batch in native.batches(steps=7):  # > 3 epochs of 2 batches
        assert "seg" not in batch and "gt_pose" in batch
        assert batch["target"].min() >= 0.0 and batch["target"].max() <= 1.0
        seen += 1
    assert seen == 7
    native.close()


def test_native_seg_and_gt_lanes(trees, tmp_path):
    """with_seg / with_gt False skip the lanes; a missing label file is
    an error, not a hang."""
    _, port, _ = trees
    native = NativeSnippetLoader(port, batch_size=4, shuffle=False, loop=False, with_seg=False, with_gt=False)
    assert set(next(native.batches())) == {"target", "sources", "K"}
    native.close()
    d = tmp_path / "partial"
    shutil.copytree(port, d)
    os.remove(d / "00_000002_seg.png")
    native = NativeSnippetLoader(str(d), batch_size=4, shuffle=False, loop=False)
    with pytest.raises(RuntimeError, match="open failed"):
        list(native.batches())
    native.close()


def test_native_shape_mismatch_error(trees, tmp_path):
    """A triplet of the wrong size surfaces as a RuntimeError."""
    _, port, _ = trees
    bad = tmp_path / "bad"
    shutil.copytree(port, bad)
    imageio.imwrite_jpg(str(bad / "00_000001.jpg"), np.zeros((32, 2 * 104, 3), np.uint8))
    native = NativeSnippetLoader(str(bad), batch_size=4, shuffle=False, loop=False)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        list(native.batches())
    native.close()


# ---------------------------------------------------------------------------
# Metrics and image summaries
# ---------------------------------------------------------------------------


def test_metrics_logger_jsonl_as_reference(tmp_path):
    """tests/test_components.py's case, both loggers on one file each."""
    for cls, d in ((MetricsLogger, tmp_path / "port"), (JMetricsLogger, tmp_path / "ref")):
        logger = cls(str(d), tensorboard=False)
        logger.log(1, {"loss": 0.5})
        logger.log(2, {"loss": torch.tensor(0.25) if cls is MetricsLogger else jnp.asarray(0.25)})
        logger.close()
        lines = (d / "metrics.jsonl").read_text().strip().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[1])
        assert rec["step"] == 2 and rec["loss"] == 0.25 and set(rec) == {"step", "wall_time", "loss"}


def test_fit_writes_image_panels(tmp_path):
    """tests/test_train.py's case: image_every > 0 and a MetricsLogger
    give the five panels as PNGs and the scalar stream."""
    cfg = Config(model=presets.get("tiny").model,
                 train=TrainConfig(batch_size=2, max_steps=2, log_every=1, image_every=1, learning_rate=1e-4))
    worlds = [SyntheticSequence(n_frames=6, height=48, width=64, seed=i) for i in range(2)]
    ds = MultiSourceDataset(worlds, batch_size=2, with_seg=True, augment=True, seed=3)
    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    loop.fit(cfg, ds.batches(steps=2), metrics_logger=logger, device="cpu")
    logger.close()
    pngs = sorted(os.listdir(tmp_path / "images"))
    names = {p.rsplit("_", 1)[0] for p in pngs}
    assert names == {"target", "source0", "warped_source0", "photometric_err", "disparity"}
    assert len(pngs) == 10
    img = imageio.imread_rgb(str(tmp_path / "images" / "target_0000002.png"))
    assert img.shape == (48, 64, 3)
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2


# ---------------------------------------------------------------------------
# The CLI chain on the CPU
# ---------------------------------------------------------------------------


def _run(argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr()


def test_cli_chain_prep_seg_train_infer(trees, tmp_path, capsys, monkeypatch):
    """prep -> train-seg -> prep --write-seg -> train (native and python
    readers, --log-dir, image summaries) -> infer, depth, ba and
    eval-depth on the KITTI root."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)  # no TensorBoard here
    root = trees[0]
    out, seg = str(tmp_path / "prepared"), str(tmp_path / "seg")
    rc, io = _run(["prep", "--dataset", "kitti_odom", "--root", root, "--out", out, "--seqs", "00,01",
                   "--height", "32", "--width", "104", "--num-workers", "1"], capsys)
    assert rc == 0 and "'train': 11" in io.out
    rc, io = _run(["train-seg", "--checkpoint-dir", seg, "--steps", "2", "--batch-size", "2", "--height", "32",
                   "--width", "104", "--channels", "8,16", "--device", "cpu"], capsys)
    assert rc == 0 and set(json.loads(io.out.strip().splitlines()[-1])) == {
        "final_loss", "eval_pixel_acc", "eval_miou", "eval_classes_present"}
    rc, io = _run(["prep", "--out", out, "--write-seg", "--seg-ckpt", seg, "--overwrite-seg", "--device", "cpu"],
                  capsys)
    assert rc == 0 and "wrote 12 seg maps" in io.out
    labels = imageio.imread_gray(os.path.join(out, "00_000001_seg.png"))
    assert labels.shape == (32, 104) and labels.max() < 19
    for reader in ("native", "python"):
        logs = tmp_path / f"logs_{reader}"
        rc, io = _run(["train", "--version", "tiny", "--data", out, "--loader", reader, "--steps", "2",
                       "--log-dir", str(logs), "--set", "train.image_every=2", "--set", "train.log_every=1",
                       "--set", "train.batch_size=2", *SIZE, "--device", "cpu"], capsys)
        assert rc == 0 and f"input pipeline: {reader}" in io.out and "step 2:" in io.out
        assert len((logs / "metrics.jsonl").read_text().splitlines()) == 2
        assert len(os.listdir(logs / "images")) == 5
    ckpt = str(tmp_path / "ck")
    rc, io = _run(["train", "--version", "tiny", "--data", root, "--seq", "00", "--steps", "1",
                   "--checkpoint-dir", ckpt, "--set", "train.batch_size=2", *SIZE, "--device", "cpu"], capsys)
    assert rc == 0
    poses, depth = str(tmp_path / "p.txt"), str(tmp_path / "depth")
    serve = ["--version", "tiny", "--data", root, "--seq", "01", "--ckpt", ckpt, *SIZE, "--device", "cpu"]
    assert _run(["infer", *serve, "--out", poses, "--gt-out", str(tmp_path / "g.txt")], capsys)[0] == 0
    rows = np.loadtxt(poses)
    assert rows.shape == (8, 12) and np.isfinite(rows).all()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "g.txt"), np.loadtxt(os.path.join(root, "poses", "01.txt")))
    assert _run(["depth", *serve, "--out", depth], capsys)[0] == 0
    assert len(os.listdir(depth)) == 8
    assert _run(["ba", *serve, "--pred", poses, "--depth-dir", depth, "--out", str(tmp_path / "r.txt"),
                 "--window", "4", "--iterations", "2"], capsys)[0] == 0
    assert np.isfinite(np.loadtxt(tmp_path / "r.txt")).all()
    rc, io = _run(["eval-depth", "--depth-dir", depth, "--gt-dir", depth, "--data", root], capsys)
    assert rc == 0 and json.loads(io.out)["abs_rel"] == 0.0
    rc, io = _run(["eval-depth", "--depth-dir", depth, "--data", root], capsys)
    assert rc == 1 and "need --gt-dir" in io.err


def test_cli_refusals_on_prepared_trees(trees, tmp_path, capsys):
    """The reference's two refusals: flow_seg without label maps, pose
    supervision without GT poses; `--loader native` raises where the
    tree cannot be probed, `auto` falls back to the Python reader."""
    _, port, _ = trees
    bare = tmp_path / "bare"
    shutil.copytree(port, bare)
    for name in os.listdir(bare):
        if name.endswith(("_seg.png", "_pose.txt")):
            os.remove(bare / name)
    base = ["train", "--version", "tiny", "--data", str(bare), "--steps", "1", *SIZE, "--device", "cpu"]
    rc, io = _run(base, capsys)
    assert rc == 1 and "no *_seg.png maps" in io.err
    rc, io = _run([*base, "--set", "model.attention=none", "--set", "train.pose_supervision_weight=1.0"], capsys)
    assert rc == 1 and "no *_pose.txt GT" in io.err
    first = (bare / "train.txt").read_text().split()[0]
    os.remove(bare / f"{first}.jpg")  # the item the native loader probes
    flat = [*base, "--set", "model.attention=none", "--set", "train.batch_size=1", "--steps", "11"]
    with pytest.raises(ValueError, match="cannot probe"):
        cli.main([*flat, "--loader", "native"])
    with pytest.raises(OSError, match="open failed"):  # the Python reader reaches the missing file
        cli.main([*flat, "--loader", "auto"])
    assert "native loader unavailable" in capsys.readouterr().err


def test_kitti_root_seg_reaches_the_model(trees, tmp_path, capsys, monkeypatch):
    """Reference fault (ROADMAP Queue 3): from a KITTI root the
    reference's `_load_sequence` returns no seg and its `train` batches
    carry none, though sequences/NN/seg/ exists; the port passes the
    root's label maps to a flow_seg model (and says so without seg/)."""
    root = trees[0]
    jcfg = j_cli._apply_sets(jpresets.get("tiny"), list(SIZE[1::2]))
    _, jseg, _, _ = j_cli._load_sequence(root, "01", jcfg, with_seg=True)
    assert jseg is None
    tcfg = cli._apply_sets(presets.get("tiny"), list(SIZE[1::2]))
    _, seg, _, _ = cli._load_sequence(root, "01", tcfg, with_seg=True)
    want = cv2.resize(cv2.imread(os.path.join(root, "sequences", "01", "seg", "000003.png"), cv2.IMREAD_GRAYSCALE),
                      (104, 32), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(seg[3], want)

    captured = {}

    def grab(key):
        def fake_fit(cfg, batches, *a, **kw):
            captured[key] = next(iter(batches))
            return None, None, []
        return fake_fit

    import davo_tpu.train.loop as jloop

    monkeypatch.setattr(jloop, "fit", grab("ref"))
    monkeypatch.setattr(loop, "fit", grab("port"))
    argv = ["train", "--version", "tiny", "--data", root, "--seq", "00", "--steps", "1",
            "--set", "train.batch_size=2", *SIZE]
    assert j_cli.main(argv) == 0
    assert cli.main([*argv, "--device", "cpu"]) == 0
    assert "seg" not in captured["ref"] and captured["port"]["seg"].shape == (2, 32, 104)

    bare = tmp_path / "noseg"
    shutil.copytree(root, bare)
    shutil.rmtree(bare / "sequences" / "01" / "seg")
    capsys.readouterr()
    _, seg, _, _ = cli._load_sequence(str(bare), "01", tcfg, with_seg=True)
    assert seg is None and "without region weights" in capsys.readouterr().err
