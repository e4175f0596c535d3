"""`tools/orbax_to_torch.py`: a checkpoint directory of the JAX package
(Orbax: params, optax state, step, config.json) served and resumed by
the port (CPU, float32, `tiny`).

The reference state is built by the reference's own `create_state`,
`_make_tx` (with the global-norm clip, so the chain's state is nested)
and two optax updates, and saved by its `save_checkpoint`; its jitted
train step is not run (its CPU compile dominates, and its gradients
differ from the op-by-op ones by ~1e-3 of a leaf: tests/test_torch_train.py).

Tolerances: Adam's moments converted exactly (the same float32 values,
kernels transposed); `cli infer --ckpt` poses within 1e-5 of the largest
of the reference's `cli infer --ckpt` on the Orbax directory; one
resumed step's loss within 1e-4 relative of the reference's loss for its
next step (run op by op).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from davo_tpu.cli.main import main as j_cli_main
from davo_tpu.config import Config as JConfig
from davo_tpu.core import warp as jwarp
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.train import loop as jloop
from davo_tpu.train.losses import total_loss as j_total_loss
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.config import Config
from davo_tpu_torch.convert import flax_to_state_dict
from davo_tpu_torch.core import warp
from davo_tpu_torch.data.snippets import MultiSourceDataset
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.train import loop

TOOL = Path(__file__).resolve().parents[1] / "tools" / "orbax_to_torch.py"
TRAIN = dict(batch_size=2, grad_clip_norm=1.0, warp_gather="take4", log_every=1)


@pytest.fixture(autouse=True)
def _restore_gathers():
    torch.set_num_threads(1)
    saved = (warp._DEFAULT_GATHER, warp._BAND), (jwarp._DEFAULT_GATHER, jwarp._BAND)
    yield
    warp.configure(*saved[0])
    jwarp.configure(*saved[1])


def _tool():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference checkpoint dir, converted dir, reference state, batch)."""
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("bridge")
    worlds = [SyntheticSequence(n_frames=6, height=48, width=64, seed=i) for i in range(2)]
    batch = next(MultiSourceDataset(worlds, batch_size=2, with_seg=True, augment=True, seed=3).batches(steps=1))
    jbase = jpresets.get("tiny")
    jcfg = dataclasses.replace(jbase, train=dataclasses.replace(jbase.train, **TRAIN))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, state, tx = jloop.create_state(jcfg, jax.random.key(0), jbatch)
    rng = np.random.default_rng(1)
    params, opt_state = state.params, state.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 0.1, p.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    state = jloop.TrainState(params=params, opt_state=opt_state, step=jnp.asarray(2, jnp.int32))
    ref = str(base / "ref")
    mngr = jloop.make_checkpoint_manager(ref)
    jloop.save_config(ref, jcfg)
    jloop.save_checkpoint(mngr, state)
    mngr.wait_until_finished()
    out = str(base / "port")
    _tool().main([ref, out])
    return ref, out, state, batch


def test_conversion_is_exact(run):
    ref, out, state, _ = run
    saved = torch.load(Path(out) / "ckpt_2.pt", weights_only=True)
    assert saved["step"] == 2 and (Path(out) / "config.json").read_text() == (Path(ref) / "config.json").read_text()
    want, _ = flax_to_state_dict(jax.tree.map(np.asarray, state.params))
    assert saved["model"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    adam = state.opt_state[1][0]  # chain(clip, adam): adam's (ScaleByAdamState, ...)
    names = list(saved["model"])
    for key in ("mu", "nu"):
        moments, _ = flax_to_state_dict(jax.tree.map(np.asarray, getattr(adam, key)))
        for name, got in zip(names, saved["optimizer"][key]):
            assert torch.equal(got, moments[name]), (key, name)


def test_port_serves_the_reference_checkpoint(run, tmp_path):
    """`cli infer --ckpt` on the converted directory against the
    reference's `cli infer --ckpt` on its Orbax directory (which restores
    the optimizer state too, so it needs the run's clip setting: the
    port's serving reads the model alone)."""
    ref, out, _, _ = run
    common = ["infer", "--version", "tiny", "--seq", "1", "--batch-size", "8", "--set", "train.grad_clip_norm=1.0"]
    assert j_cli_main([*common, "--ckpt", ref, "--out", str(tmp_path / "j.txt")]) == 0
    assert cli_main([*common, "--ckpt", out, "--out", str(tmp_path / "t.txt"), "--device", "cpu"]) == 0
    want, got = np.loadtxt(tmp_path / "j.txt"), np.loadtxt(tmp_path / "t.txt")
    assert got.shape == want.shape == (32, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_port_resumes_the_reference_run(run):
    """`fit` from the converted directory takes step 3 with the loss the
    reference's step would report, and saves step 3."""
    _, out, state, batch = run
    base = presets.get("tiny")
    cfg = Config(model=base.model, train=dataclasses.replace(base.train, max_steps=1, **TRAIN))
    _, resumed, history = loop.fit(cfg, [batch], checkpoint_dir=out, device="cpu")
    assert resumed.step == 3 and [s for s, _ in loop._checkpoints(out)] == [2, 3]

    jwarp.configure("take4")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = JConfig(model=jpresets.get("tiny").model, train=dataclasses.replace(jpresets.get("tiny").train, **TRAIN))
    outputs = JDavoModel(jcfg.model).apply(
        state.params, jb["target"], jb["sources"], seg=jb["seg"], train=True,
        source_disp=jcfg.train.geo_consistency_weight > 0,
    )
    _, want = j_total_loss(outputs, jb, jcfg.model, jcfg.train, step=jnp.asarray(2, jnp.int32))
    np.testing.assert_allclose(history[-1]["total"], float(want["total"]), rtol=1e-4)
