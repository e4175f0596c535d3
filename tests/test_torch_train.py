"""The port's train step, optimizer, data and fit loop against the JAX
package (CPU, float32, `tiny`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from davo_tpu.config import Config as JConfig
from davo_tpu.config import TrainConfig as JTrainConfig
from davo_tpu.core import warp as jwarp
from davo_tpu.data.snippets import MultiSourceDataset as JMultiSourceDataset
from davo_tpu.data.synthetic import SyntheticSequence as JSyntheticSequence
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.train import loop as jloop
from davo_tpu.train.losses import total_loss as j_total_loss
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.config import Config, TrainConfig
from davo_tpu_torch.convert import flax_to_state_dict, load_flax_params
from davo_tpu_torch.core import warp
from davo_tpu_torch.data.prefetch import PrefetchStats, device_prefetch
from davo_tpu_torch.data.snippets import MultiSourceDataset
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.train import loop
from davo_tpu_torch.train.losses import total_loss
from torch_float64 import reference_float64 as reference_float64_program
from torch_float64 import to_float64, worst_leaf

TINY = presets.get("tiny").model
J_TINY = jpresets.get("tiny").model
STEP = 125  # mid-warm-up: the depth gate is open at half strength


@pytest.fixture(autouse=True)
def _restore_gathers():
    yield from restore_gathers()


def restore_gathers():
    torch.set_num_threads(1)
    saved = (warp._DEFAULT_GATHER, warp._BAND), (jwarp._DEFAULT_GATHER, jwarp._BAND)
    yield
    warp.configure(*saved[0])
    jwarp.configure(*saved[1])


def _worlds(cls, n=2):
    return [cls(n_frames=6, height=48, width=64, seed=i) for i in range(n)]


def make_batch() -> dict:
    """One augmented `tiny` batch (B=2, two sources, seg) from the port's
    data layer."""
    ds = MultiSourceDataset(_worlds(SyntheticSequence), batch_size=2, with_seg=True, augment=True, seed=3)
    return next(ds.batches(steps=1))


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def test_snippet_batches_match_reference():
    """The copied data layer draws the same snippets and augmentation;
    the zoom's bilinear resize is NumPy here and OpenCV in the reference
    (1e-4: OpenCV's float path rounds its weights differently)."""
    kw = dict(batch_size=2, with_seg=True, with_gt=True, augment=True, seed=4)
    got = list(MultiSourceDataset(_worlds(SyntheticSequence), **kw).batches(steps=3))
    want = list(JMultiSourceDataset(_worlds(JSyntheticSequence), **kw).batches(steps=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"target", "sources", "K", "seg", "gt_pose"}
        for key in g:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4, err_msg=key)
        assert np.mean(g["seg"] != w["seg"]) == 0


def test_device_prefetch_on_cpu_yields_tensors(batch):
    stats = PrefetchStats()
    out = list(device_prefetch([batch, batch, batch], "cpu", stats=stats))
    assert len(out) == 3 and stats.batches == 3
    for key, value in batch.items():
        assert torch.equal(out[2][key], torch.from_numpy(value))


def _reference_step(jcfg, params, batch, step, jit=False):
    mcfg, tcfg = jcfg.model, jcfg.train

    def loss_fn(p):
        out = JDavoModel(mcfg).apply(
            p, batch["target"], batch["sources"], seg=batch["seg"], train=True, source_disp=True
        )
        return j_total_loss(out, batch, mcfg, tcfg, step=jnp.asarray(step, jnp.int32))

    step_fn = jax.value_and_grad(loss_fn, has_aux=True)
    (_, metrics), grads = (jax.jit(step_fn) if jit else step_fn)(params)
    return {k: float(v) for k, v in metrics.items()}, grads


def _reference_run(jcfg, params, batch, jit=False) -> tuple[dict, dict]:
    """(loss terms, gradient leaves by the port's names, as float64
    tensors) of the reference's step, op by op or under `jax.jit`."""
    metrics, grads = _reference_step(jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()}, STEP, jit)
    leaves, _ = flax_to_state_dict(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads))
    return metrics, leaves


def _port_run(cfg, model, batch) -> tuple[dict, dict]:
    """(loss terms, gradient leaves) of the port's step."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    out = model(tb["target"], tb["sources"], seg=tb["seg"], train=True, source_disp=True)
    loss, metrics = total_loss(out, tb, cfg.model, cfg.train, step=STEP)
    loss.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad for n, p in model.named_parameters()})


def check_train_step_against_reference(batch, gather, flags=None):
    """tiny (with the model `flags` set), flow_seg attention, geometry
    consistency on, each package in float32 and in float64 on the same
    seeded parameters and batch: the reference op by op, and under
    `jax.jit` in float64 (`torch_float64.reference_float64`); the port,
    its float64 under chip_smoke.py's `_float64_program`.

    - The function: the two float64 runs agree, every loss term within
      1e-10 of the total and every gradient leaf, by name through the
      converter, within 1e-6 of that leaf's largest magnitude.
    - The rounding: the port's worst leaf from its own float64 at most
      twice the reference's worst leaf from its own float64, or 1e-5.

    The float32 runs are not held to each other: any two float32 sums of
    the same step round differently, and a few bilinear taps then cross
    a cell edge. `jax.jit` of the reference moves whole-model gradients
    by up to ~1e-3 of a leaf against the same reference op by op in
    float32, and each port forward more exact than oneDNN's redrew which
    of the three `tiny` steps missed the reference's float32 at 1e-4.
    Their gap is printed beside each package's distance from float64.
    In float64 the jitted reference lies within ~3e-9 of a leaf of the
    same run op by op, and runs in a fraction of its time (the banded
    reference's interpret-mode kernels most of all).

    With fused `flags` both float64 runs are the unfused program: the
    fused chains have no float64 mode, and their plain versions compute
    the unfused layers' function."""
    flags = flags or {}
    unfused = {k: False for k in flags if k.startswith("fuse_")}
    jcfg = JConfig(model=dataclasses.replace(J_TINY, **flags), train=JTrainConfig(batch_size=2))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = JDavoModel(J_TINY).init(
        jax.random.key(0), jbatch["target"], jbatch["sources"], seg=jbatch["seg"],
        train=True, source_disp=True,
    )
    warp.configure(gather, (2, 4))
    jwarp.configure(gather, (2, 4))
    ref32 = _reference_run(jcfg, params, batch)
    batch64 = to_float64(batch)
    jcfg64 = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, **unfused))
    with reference_float64_program():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref64 = _reference_run(jcfg64, params64, batch64, jit=True)

    cfg = Config(model=dataclasses.replace(TINY, **flags), train=TrainConfig(batch_size=2))
    model = loop.create_state(cfg, "cpu").model
    load_flax_params(model, params)
    port32 = _port_run(cfg, model, batch)
    with chip_smoke._float64_program(torch) as seen:
        cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float64", **unfused))
        model64 = DavoModel(cfg64.model, device="cpu", seed=0, dispnet=True).double()
        model64.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
        seen.clear()
        port64 = _port_run(cfg64, model64, batch64)
    assert seen == {torch.float64}, seen

    (want_metrics, want_grads), (metrics, got_grads) = ref32, port32
    assert metrics.keys() == want_metrics.keys() == port64[0].keys() == ref64[0].keys()
    assert got_grads.keys() == want_grads.keys() == port64[1].keys() == ref64[1].keys()
    for name, g in got_grads.items():
        assert g is not None, name
    ref, port = worst_leaf(want_grads, ref64[1]), worst_leaf(got_grads, port64[1])
    gap64, gap32 = worst_leaf(port64[1], ref64[1]), worst_leaf(got_grads, want_grads)
    print(f"{gather} {sorted(flags)}: worst leaf from its own float64: reference {ref}, port {port}; "
          f"port64 vs ref64 {gap64}; float32 port vs reference {gap32}")
    total = abs(ref64[0]["total"])
    for key, value in port64[0].items():
        np.testing.assert_allclose(value, ref64[0][key], rtol=0, atol=1e-10 * total, err_msg=key)
    assert gap64[1] <= 1e-6, gap64
    assert port[1] <= max(2 * ref[1], 1e-5), (port, ref)
    assert any(float(g.abs().max()) > 0 for n, g in got_grads.items() if n.startswith("dispnet."))


def test_train_step_matches_reference(batch):
    """Under the exact take4 gather (the banded case is
    tests/test_torch_train_banded.py, which runs on its own worker)."""
    check_train_step_against_reference(batch, "take4")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(grad_clip_norm=0.05), dict(lr_schedule="cosine", max_steps=3, grad_clip_norm=10.0)],
    ids=["constant", "clipped", "cosine"],
)
def test_optimizer_matches_optax_on_identical_gradients(kw):
    """Adam (beta1 0.9, beta2 0.999, eps 1e-8), optax's global-norm clip
    (no epsilon) and the cosine schedule (count read before the update)
    against the reference's `_make_tx`: after each of three updates the
    parameters agree within 1e-6 of each leaf's update scale. They start
    at 0, so that they hold the sums of the updates without the rounding
    of adding a small update to a large value."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(scale=0.1, size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    tkw = dict(learning_rate=1e-2, **kw)
    tx = jloop._make_tx(JConfig(train=JTrainConfig(**tkw)))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    port = loop._make_tx(Config(train=TrainConfig(**tkw)), tparams.values())
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        port.step(count)
        for k, p in tparams.items():
            scale = float(np.abs(np.asarray(updates[k])).max())
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6 * scale, err_msg=k
            )
    if kw.get("lr_schedule") == "cosine":
        assert port.learning_rate(3) == pytest.approx(1e-4)


def _cfg(**train_kw):
    return Config(model=TINY, train=TrainConfig(batch_size=2, max_steps=1, **train_kw))


def test_remat_gives_the_same_update(batch):
    results = []
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        state = loop.create_state(cfg, "cpu")
        _, metrics = loop.make_train_step(cfg, "cpu")(state, batch)
        results.append((float(metrics["total"]), [p.detach().clone() for p in state.model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


def test_checkpoint_round_trip_and_resume(batch, tmp_path):
    cfg = _cfg(checkpoint_every=1)
    _, state, history = loop.fit(cfg, [batch], checkpoint_dir=str(tmp_path), device="cpu")
    assert state.step == 1 and len(history) == 1 and np.isfinite(history[0]["total"])
    assert loop.load_config(str(tmp_path))["train"]["batch_size"] == 2
    fresh = loop.create_state(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=9)), "cpu")
    assert loop.restore_checkpoint(str(tmp_path), fresh) is fresh and fresh.step == 1
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    saved, restored = state.tx.state_dict(), fresh.tx.state_dict()
    for a, b in zip(saved["mu"] + saved["nu"], restored["mu"] + restored["nu"]):
        assert torch.equal(a, b)
    assert any(bool(v.any()) for v in restored["nu"])
    # fit resumes from the newest checkpoint and keeps at most three.
    more = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=4))
    _, state2, _ = loop.fit(more, [batch] * 4, checkpoint_dir=str(tmp_path), device="cpu")
    assert state2.step == 5
    assert [s for s, _ in loop._checkpoints(str(tmp_path))] == [3, 4, 5]


def test_warp_gather_policy():
    device_cpu, device_cuda = torch.device("cpu"), torch.device("cuda")
    loop._apply_warp_config(_cfg(), device_cpu)
    assert warp._DEFAULT_GATHER == "take4"
    loop._apply_warp_config(_cfg(), device_cuda)  # resolution only: nothing runs
    assert (warp._DEFAULT_GATHER, warp._BAND) == ("banded", (4, 16))
    loop._apply_warp_config(_cfg(warp_gather="take4"), device_cuda)
    assert warp._DEFAULT_GATHER == "take4"
    loop._apply_warp_config(_cfg(warp_gather="banded", warp_band=(2, 4)), device_cpu)
    assert (warp._DEFAULT_GATHER, warp._BAND) == ("banded", (2, 4))


def test_auto_gather_respects_the_environment(monkeypatch):
    warp.configure("block", (3, 5))
    monkeypatch.setenv("DAVO_WARP_GATHER", "block")
    loop._apply_warp_config(_cfg(), torch.device("cuda"))
    assert (warp._DEFAULT_GATHER, warp._BAND) == ("block", (3, 5))


def test_fit_refuses_image_summaries(batch, tmp_path):
    """image_every > 0 renders panels only for a MetricsLogger: without
    one, fit trains and writes nothing; with one, every image_every
    steps (tests/test_torch_data_real.py holds the panels)."""
    from davo_tpu_torch.utils.metrics import MetricsLogger

    _, state, _ = loop.fit(_cfg(image_every=5), [batch], device="cpu")
    assert state.step == 1
    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    loop.fit(_cfg(image_every=1), [batch], device="cpu", metrics_logger=logger)
    logger.close()
    assert len(list((tmp_path / "images").iterdir())) == 5


def test_cli_train_runs_on_cpu(tmp_path, capsys):
    rc = cli_main([
        "train", "--version", "tiny", "--steps", "2", "--device", "cpu", "--worlds", "2",
        "--world-frames", "6", "--checkpoint-dir", str(tmp_path), "--set", "train.log_every=1",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "step 2:" in out and "geo_consistency=" in out and "prefetch:" in out
    assert [s for s, _ in loop._checkpoints(str(tmp_path))] == [2]


@pytest.mark.parametrize("flags", [["--data", "/kitti"], ["--log-dir"], ["--set", "train.image_every=1"]])
def test_cli_train_refuses_unported_inputs(flags, tmp_path, capsys, monkeypatch):
    """A KITTI root that is not there fails in its reader; --log-dir and
    image summaries train (metrics.jsonl; panels only with --log-dir)."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)  # no TensorBoard here
    if flags == ["--log-dir"]:
        flags = ["--log-dir", str(tmp_path / "logs")]
    argv = ["train", "--version", "tiny", "--steps", "1", "--device", "cpu", "--worlds", "1",
            "--world-frames", "4", "--set", "train.batch_size=2", *flags]
    if "/kitti" in flags:
        with pytest.raises(FileNotFoundError):
            cli_main(argv)
        return
    assert cli_main(argv) == 0
    assert "not ported" not in capsys.readouterr().err
    if "--log-dir" in flags:
        assert (tmp_path / "logs" / "metrics.jsonl").read_text().count("\n") == 1


def test_train_entry_points_default_to_the_gpu(batch, tmp_path):
    """Without a card, fit and `cli train` called without device="cpu"
    raise instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.fit(_cfg(), [batch])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["train", "--version", "tiny", "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
