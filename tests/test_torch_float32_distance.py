"""How far a float32 train step lands from float64: the reference against the port (CPU).

One `davo`-width train step at chip_smoke.py phase 9's configuration
(64x128, float32, B=2, the synthetic-world batch, the depth gate half
open), in four runs on the same seeded parameters and batch: the
reference in float32 and in float64 (`jax.enable_x64(True)` as a
context, every explicit float32 of its program read as float64 while
open), the port in float32 and in float64 (chip_smoke.py's
`_float64_program`). Each package's worst gradient leaf from its own
float64 run (max |g32 - g64| over the leaf's largest |g64|) is printed;
the port's must be at most twice the reference's, or 1e-4. Phase 9 has
two batches: independent noise images, and the synthetic world's, whose
frames are nearly alike, so SSIM's (1 - s)/2 cancels and float32
rounding moves gradient leaves by up to 1e-2 of their largest. On the
noise batch the port lands 1.44x the reference's distance; on the world
batch 2.17x, in the flow net's leaves: a fault logged in ROADMAP Queue 3
and held here as a strict expected failure, so that the run that fixes
it fails until the entry is closed.

Phase 9's size, not 128x416: at 128x416 the four runs take over two
minutes on one worker (the reference's two compiles and the float64
runs). Both packages warp with the exact take4 gather: the reference's
banded gather is a Pallas kernel, minutes in interpret mode here. Both
run as they run in use, the reference under `jax.jit`.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from davo_tpu.core import warp as jwarp
from davo_tpu.data.snippets import MultiSourceDataset as JMultiSourceDataset
from davo_tpu.data.synthetic import SyntheticSequence as JSyntheticSequence
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.train.losses import total_loss as j_total_loss
from davo_tpu_torch.convert import flax_to_state_dict, load_flax_params
from davo_tpu_torch.core import warp
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.train.losses import total_loss

STEP = 125  # phase 9's: the depth warm-up gate half open
SIZE = dict(img_height=64, img_width=128, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _take4():
    torch.set_num_threads(1)
    saved = (warp._DEFAULT_GATHER, warp._BAND), (jwarp._DEFAULT_GATHER, jwarp._BAND)
    warp.configure("take4")
    jwarp.configure("take4")
    yield
    warp.configure(*saved[0])
    jwarp.configure(*saved[1])


@contextlib.contextmanager
def _reference_float64():
    """x64 on, and `jnp.float32` read as float64 while open: the
    reference's explicit float32 casts (its compute dtype, `.astype`,
    zeros, grids) compute in float64."""
    real = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = real


def _batch(name):
    """Phase 9's batches, from the reference's data layer: the synthetic
    world's, or the same with independent noise images."""
    world = JSyntheticSequence(n_frames=5, height=64, width=128, seed=7)
    batch = next(JMultiSourceDataset([world], batch_size=2, with_seg=True, augment=True, seed=1).batches(steps=1))
    if name == "noise":
        rng = np.random.default_rng(8)
        for key in ("target", "sources"):
            batch[key] = rng.uniform(size=batch[key].shape).astype(np.float32)
    return batch


def _reference_grads(jcfg, params, batch):
    mcfg, tcfg = jcfg.model, jcfg.train

    @jax.jit
    def grads(p, b):
        def loss_fn(p):
            out = JDavoModel(mcfg).apply(p, b["target"], b["sources"], seg=b["seg"], train=True, source_disp=True)
            return j_total_loss(out, b, mcfg, tcfg, step=jnp.asarray(STEP, jnp.int32))[0]

        return jax.grad(loss_fn)(p)

    g = grads(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return flax_to_state_dict(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g))[0]


def _port_grads(cfg, model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    out = model(tb["target"], tb["sources"], seg=tb["seg"], train=True, source_disp=True)
    total_loss(out, tb, cfg.model, cfg.train, step=STEP)[0].backward()
    return {n: p.grad.detach().double() for n, p in model.named_parameters()}


def _worst(got, exact):
    errs = {n: float((got[n].double() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for n, w in exact.items()}
    return max(errs.items(), key=lambda kv: kv[1])


WORLD_XFAIL = pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3: on the world batch the port's CPU float32 (oneDNN's convolutions) lands 9.99e-3 of "
    "flownet.estimator1.est2's bias from float64, 2.17x the jitted reference's worst leaf (4.61e-3); the "
    "flow net's gradients, which SSIM's cancellation on nearly alike frames amplifies (1.44x on the noise batch)"))


@pytest.mark.parametrize("name", ["noise", pytest.param("world", marks=WORLD_XFAIL)])
def test_port_lands_no_further_from_float64_than_the_reference(name):
    batch = _batch(name)
    jcfg = jpresets.with_overrides("davo", **SIZE)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, batch_size=2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = JDavoModel(jcfg.model).init(jax.random.key(0), jb["target"], jb["sources"], seg=jb["seg"],
                                         train=True, source_disp=True)
    ref32 = _reference_grads(jcfg, params, batch)
    with _reference_float64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
        ref64 = _reference_grads(jcfg, params64, batch64)

    cfg = presets.with_overrides("davo", **SIZE)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=2))
    model = DavoModel(cfg.model, device="cpu", seed=0, dispnet=True)
    load_flax_params(model, params)
    port32 = _port_grads(cfg, model, batch)
    with chip_smoke._float64_program(torch):
        cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float64"))
        model64 = DavoModel(cfg64.model, device="cpu", seed=0, dispnet=True).double()
        model64.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
        b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
        port64 = _port_grads(cfg64, model64, b64)

    assert ref32.keys() == port32.keys() == ref64.keys() == port64.keys()
    # The two float64 runs compute one function: they must agree closely.
    exact_gap = _worst(port64, ref64)
    ref, port = _worst(ref32, ref64), _worst(port32, port64)
    print(f"{name} batch, worst leaf from its own float64: reference {ref}, port {port}; "
          f"port64 vs ref64 {exact_gap}")
    assert exact_gap[1] <= 1e-6
    assert port[1] <= max(2 * ref[1], 1e-4)
